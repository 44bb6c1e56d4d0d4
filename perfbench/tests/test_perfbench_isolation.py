"""Nothing the benchmark runs loads JAX or the JAX package, and the plain
reference loads nothing of the program. Modules are compared by their
top-level name, whole: ``repro_torch`` is the port, ``repro`` the JAX
package."""
import ast
import subprocess
import sys
import types

import run
from conftest import BENCH, ROOT

RUN_SMOKE = f"""
import sys, time
sys.path[:0] = [{str(BENCH)!r}, {str(ROOT / 'src')!r}]
sys.path.insert(0, {str(BENCH / 'tests')!r})
from conftest import smoke_cell
import harness, run
cell = smoke_cell("qwen2-7b.conv-poisson")
out = harness.run_cell(cell, 3, 1.0, True, device="cpu",
                       process_start=time.perf_counter(), use_kernels=False)
assert out["correct"], out
print("FORBIDDEN", run.forbidden_modules())
print("PORT", "repro_torch" in sys.modules)
"""


def test_a_whole_run_loads_no_jax_nor_the_jax_package():
    res = subprocess.run([sys.executable, "-c", RUN_SMOKE],
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "FORBIDDEN []" in res.stdout
    assert "PORT True" in res.stdout      # the port did run


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_lookalike",
                        types.ModuleType("repro_torch_lookalike"))
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "repro.core",
                        types.ModuleType("repro.core"))
    assert run.forbidden_modules() == ["repro"]


def test_the_reference_loads_nothing_of_the_program():
    code = (f"import sys; sys.path.insert(0, {str(BENCH)!r}); "
            "import reference, check; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'repro_torch', 'repro', 'jax', 'jaxlib', 'flax'}))")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.strip() == "[]"
    for name in ("reference.py", "check.py"):
        tree = ast.parse((BENCH / name).read_text())
        mods = {a.name.split(".")[0] for n in ast.walk(tree)
                if isinstance(n, ast.Import) for a in n.names}
        mods |= {n.module.split(".")[0] for n in ast.walk(tree)
                 if isinstance(n, ast.ImportFrom) and n.module}
        assert mods <= {"__future__", "contextlib", "typing", "numpy",
                        "torch", "reference"}, (name, mods)
