"""Shared set-up of the benchmark's own tests.

The harness's modules and the port's package are put on the path; no JAX
is imported. Tests that need a card carry the ``chip`` marker and take the
``chip`` fixture, which skips them where ``torch.cuda`` finds no device
(decided when the test runs, never at import). A smoke-size cell, the
harness's whole run on the CPU at the widths its model family gives for
tests, is built by :func:`smoke_cell`.
"""
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
BENCH = HERE.parent
ROOT = BENCH.parent
for p in (str(BENCH), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chip: needs a CUDA device; skipped where none is found")


@pytest.fixture
def chip():
    """Skip the test unless a CUDA device is present."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")


def smoke_cell(workload: str, layers: int = 2, mix: str = None,
               root: Path = ROOT):
    """The cell ``workload`` (of ``<root>/BENCHMARK.json``) at its
    family's smoke widths (``smoke(config)``) and ``layers`` layers, with
    a short mix that keeps its loop (or that of
    ``perfbench/traffic/<mix>`` where ``mix`` is given): prompts ~60
    tokens, outputs ~8, 1 s of warm-up."""
    import json
    import harness
    cell = harness.load_cell(workload, root)
    if mix is not None:
        cell.mix = json.loads((BENCH / "traffic" / f"{mix}.json").read_text())
    cell.config = dict(cell.family.smoke(cell.config),
                       num_hidden_layers=layers)
    cell.config["serving"] = dict(cell.config["serving"], max_slots=8,
                                  num_kv_blocks=256)
    cell.mix = {**cell.mix, "rate": 4.0, "clients": 6, "mean_in": 60,
                "min_in": 4, "max_in": 400, "mean_out": 8, "min_out": 2,
                "max_out": 32, "warmup_s": 1.0}
    return cell
