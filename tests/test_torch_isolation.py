"""The port stands alone: no JAX and nothing of the JAX package.

Every ``repro_torch`` module is imported in a fresh interpreter, which
must end with neither ``jax`` nor ``repro`` (or any ``repro.*``) loaded.
``chip_smoke.py`` is held to the same rule, and refuses to run without a
card. The entry points default to the card and raise without one, bar
the dry-run (``repro_torch.launch.dryrun`` and ``sweep``), which is
device-free by design: it counts the port's step on the meta device, as
the JAX package's needs no TPU.
"""
import ast
import dataclasses
import importlib.util
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]

_PROBE = r"""
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                "repro_torch.")]
for name in names:
    importlib.import_module(name)
assert {"repro_torch.training.trainer", "repro_torch.training.checkpoint",
        "repro_torch.launch.train", "repro_torch.launch.dryrun",
        "repro_torch.launch.sweep", "repro_torch.launch.specs",
        "repro_torch.launch.mesh", "repro_torch.launch.roofline",
        "repro_torch.models.sharding"} <= set(names)
leaked = sorted(m for m in sys.modules
                if m == "jax" or m.startswith("jax.")
                or m == "repro" or m.startswith("repro."))
print(len(names), leaked)
"""


def _env():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.pop("PYTHONSTARTUP", None)
    return env


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    out = subprocess.run([sys.executable, "-c", _PROBE], env=_env(),
                         capture_output=True, text=True, timeout=120,
                         check=True).stdout.split(maxsplit=1)
    n_modules, leaked = int(out[0]), out[1].strip()
    assert n_modules >= 30
    assert leaked == "[]"


def test_chip_smoke_imports_no_jax():
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            roots.add((node.module or "").split(".")[0])
    assert "repro_torch" in roots
    assert not roots & {"jax", "jaxlib", "repro"}


def test_chip_smoke_fails_without_a_card_or_a_checkout(tmp_path, capsys,
                                                      monkeypatch):
    """No CUDA here: exit 1 and no result line. Alone in a directory, it
    fails too (a card or not)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    monkeypatch.setattr(sys, "argv", ["chip_smoke.py"])
    assert chip_smoke.main() == 1
    assert '"ok"' not in capsys.readouterr().out
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(ROOT / "chip_smoke.py", alone)
    env = dict(_env(), PYTHONPATH="")
    run = subprocess.run([sys.executable, str(alone)], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert run.returncode != 0 and '"ok"' not in run.stdout


def test_entry_points_default_to_the_card():
    """The executor factories, ``ServeSpec.build`` and the launcher run
    on CUDA unless asked for the CPU: without a card they raise or exit
    non-zero, and with ``device="cpu"`` / ``--device cpu`` they run. The
    paged executor refuses CUDA kernels for a model on the CPU."""
    from repro_torch.configs import get_config
    from repro_torch.core.executor import PagedRealExecutor
    from repro_torch.serving.api import (ServeSpec, paged_executor_factory,
                                         slot_executor_factory)
    from repro_torch.serving.trace import make_trace
    cfg = get_config("llama3-8b", smoke=True)
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        paged_executor_factory(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        slot_executor_factory(cfg, max_slots=2, s_kv=64)
    factory = paged_executor_factory(cfg, device="cpu")
    ex = factory("ppi")
    assert ex.device.type == "cpu" and ex.use_kernels is False
    with pytest.raises(ValueError, match="CUDA"):
        PagedRealExecutor(ex.model, use_kernels=True)

    specs = [ServeSpec(smoke=True, executor=e, s_kv=64, max_slots=4,
                       block_size=4) for e in ("paged", "real")]
    for spec in specs:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            spec.build()
        res = spec.build(device="cpu").run(
            make_trace(3, seed=0, vocab_size=cfg.vocab_size, scale=0.01))
        assert res["completed"] == 3
    assert ServeSpec().build().run(make_trace(3, seed=0))["completed"] == 3

    argv = [sys.executable, "-m", "repro_torch.launch.serve", "--smoke",
            "--executor", "paged", "--n-requests", "2", "--scale", "0.01"]
    run = subprocess.run(argv, env=_env(), capture_output=True, text=True,
                         timeout=300)
    assert run.returncode != 0 and "device='cpu'" in run.stderr
    assert '"completed"' not in run.stdout
    run = subprocess.run(argv + ["--device", "cpu"], env=_env(),
                         capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr
    assert json.loads(run.stdout)["completed"] == 2


def test_factory_refuses_weights_on_another_device():
    """Weights that lie elsewhere than the factory's ``device`` raise; they
    are never run where they happen to be. (``meta`` stands in for a second
    device on a machine without a card.)"""
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import DecoderModel, init_params
    from repro_torch.serving.api import paged_executor_factory
    cfg = dataclasses.replace(get_config("llama3-8b", smoke=True),
                              n_layers=1, vocab_size=512)
    cpu_params = init_params(cfg, generator=torch.Generator().manual_seed(0),
                             device="cpu")

    def to_meta(tree):
        return {k: to_meta(v) if isinstance(v, dict) else v.to("meta")
                for k, v in tree.items()}
    meta_params = to_meta(cpu_params)
    with pytest.raises(ValueError, match="lies on meta"):
        paged_executor_factory(cfg, params=meta_params, device="cpu")
    with pytest.raises(ValueError, match="lies on cpu"):
        paged_executor_factory(cfg, params=cpu_params, device="meta")
    model = DecoderModel(cfg, cpu_params, device="cpu")
    with pytest.raises(ValueError, match="lies on cpu"):
        paged_executor_factory(cfg, model=model, device="meta")
    with pytest.raises(ValueError, match="lies on meta"):
        paged_executor_factory(cfg, model=model, params=meta_params,
                               device="cpu")
    with pytest.raises(ValueError, match="lies on cpu"):
        DecoderModel(cfg, cpu_params, device="meta")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            paged_executor_factory(cfg, params=cpu_params)
