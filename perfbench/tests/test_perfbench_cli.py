"""The command: it refuses to run without a card, and in a directory that
holds only ``BENCHMARK.json`` and the benchmark's files; on a card, one
short run of a cell is correct."""
import json
import shutil
import subprocess
import sys

import pytest

from conftest import BENCH, ROOT

ARGS = ["--workload", "qwen2-7b.conv-poisson", "--seed", "2147483659",
        "--seconds", "5", "--trace", "0"]


def _run(cwd):
    return subprocess.run([sys.executable, "perfbench/run.py", *ARGS],
                          cwd=cwd, capture_output=True, text=True,
                          timeout=900)


def _no_result(res):
    lines = res.stdout.strip().splitlines()
    return not lines or not lines[-1].startswith("{")


def test_refuses_without_a_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    res = _run(ROOT)
    assert res.returncode != 0 and _no_result(res)
    assert "CUDA device" in res.stderr


def test_refuses_with_only_the_benchmark_files(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    res = _run(tmp_path)
    assert res.returncode != 0 and _no_result(res)


@pytest.mark.chip
def test_one_short_run_on_the_card_is_correct(chip):
    res = _run(ROOT)
    assert res.returncode == 0, res.stderr[-3000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["correct"] is True
    assert out["device"]["platform"] == "gpu"
