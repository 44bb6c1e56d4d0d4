"""Readings that the limit of ``correct`` is set from, on the card.

    python3 perfbench/control.py --workload qwen2-7b.conv-poisson \
        --seeds 11,12,13 --seconds 20

For each seed, in one process: a run of the cell as ``run.py`` makes it
(its traffic, warm-up and load, a window of ``--seconds``), then the
comparison of its sample of served tokens with the plain reference of the
cell's model family, which gives the program's widest gap (a lower
reading), and the control's on the same positions: that same reference
in fp8 put in the program's place (an upper reading). One JSON line per seed. The benchmark's own runs never run the
control.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def main() -> int:
    """Parse the arguments and print one line of readings per seed."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    import harness
    harness.checkout_caches()
    if not torch.cuda.is_available():
        print("control: needs a CUDA device", file=sys.stderr)
        return 2
    cell = harness.load_cell(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        out = harness.run_cell(cell, seed, args.seconds, False,
                               device="cuda",
                               process_start=time.perf_counter(),
                               control=True)
        info = out["info"]
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "gap_max": out["checks"]["logit_gap_max"]["value"],
                          "control_gap_max": info["control_gap_max"],
                          "tokens_checked": info["tokens_checked"],
                          "requests_checked": info["requests_checked"],
                          "served_max": info["served_max"],
                          "metrics": {k: v["value"] for k, v in
                                      out["metrics"].items()},
                          "info": info}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
