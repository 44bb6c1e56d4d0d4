"""Run one cell of the benchmark once and print its result line.

    python3 perfbench/run.py --workload qwen2-7b.conv-poisson --seed 7 \
        --seconds 50 --trace 0

Builds the cell's Cronus pair of the port on the card, serves its traffic
mix for the mix's warm-up and then ``--seconds`` of window on the host
clock, compares a sample of the served tokens with the plain reference,
and prints, as the last line of standard output, one JSON object: the
cell's end-to-end metrics (``--trace 0``) or its per-layer metrics
(``--trace 1``), whether the served tokens are correct, and the device.
Each compared number and its limit are the last lines of standard error
and the last key of the result.

Exits non-zero with no result without a CUDA device, and when a module of
``jax``, ``jaxlib``, ``flax`` or the JAX package ``repro`` is loaded once
the window has closed.
"""
from __future__ import annotations

import os
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def process_start() -> float:
    """The process's start on the ``perf_counter`` clock (from
    ``/proc/self/stat``; this line's time where that cannot be read)."""
    now = time.perf_counter()
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        elapsed = uptime - int(fields[19]) / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return now
    return now - max(elapsed, 0.0)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


def main() -> int:
    """Parse the arguments, run the cell, print the result."""
    start = process_start()
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()

    sys.path.insert(0, str(ROOT / "src"))
    import json

    import torch

    import harness
    harness.checkout_caches()
    cell = harness.load_cell(args.workload)
    chips = next(w["chips"] for w in json.loads(
        (ROOT / "BENCHMARK.json").read_text())["workloads"]
        if w["name"] == args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"perfbench: {args.workload} needs {chips} CUDA device(s); "
              f"this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    out = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                           device="cuda", process_start=start)
    bad = forbidden_modules()
    if bad:
        print(f"perfbench: modules of {bad} were loaded in this process",
              file=sys.stderr)
        return 3
    info = out.pop("info")
    print(json.dumps({"info": info, "workload": args.workload,
                      "seed": args.seed}), flush=True)
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr, flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
