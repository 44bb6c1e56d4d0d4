"""Nothing the benchmark runs loads JAX or the JAX package, and the plain
references (``reference.py`` and every ``families/*_reference.py``) and
the comparison load nothing of the program. Modules are compared by their
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


def _references():
    """``reference.py``, ``check.py`` and every family's reference,
    ``families/*_reference.py``, found by glob."""
    return [BENCH / "reference.py", BENCH / "check.py",
            *sorted((BENCH / "families").glob("*_reference.py"))]


def test_the_reference_loads_nothing_of_the_program():
    paths = _references()
    code = (f"import sys, importlib.util; sys.path.insert(0, {str(BENCH)!r})\n"
            f"for i, p in enumerate({[str(p) for p in paths]!r}):\n"
            "    spec = importlib.util.spec_from_file_location(f'ref{i}', p)\n"
            "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'repro_torch', 'repro', 'jax', 'jaxlib', 'flax'}))")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.strip() == "[]"
    allowed = {"torch", "numpy"} | set(sys.stdlib_module_names)
    for path in paths:
        tree = ast.parse(path.read_text())
        mods = {a.name.split(".")[0] for n in ast.walk(tree)
                if isinstance(n, ast.Import) for a in n.names}
        mods |= {n.module.split(".")[0] for n in ast.walk(tree)
                 if isinstance(n, ast.ImportFrom) and n.module}
        assert mods <= allowed, (path.name, mods - allowed)
