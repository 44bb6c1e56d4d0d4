"""Find an open-loop cell's knee once, on the card.

    python3 perfbench/sweep.py --workload qwen2-7b.conv-poisson \
        --rates 1.0,1.5,2.0,2.5 --seconds 30 --seed 5

Runs the cell at each offered rate (its mix otherwise as it stands: the
same lengths, warm-up and window logic as ``run.py``) and prints one JSON
line a rate: TTFT and TBT on the host clock, tokens/s, and the backlog
(requests due without a first token) when the window opens and when it
closes. The knee is the highest rate the pair sustains: its backlog does
not grow over the window, and the output tokens it asks for a second (the
rate times the mix's mean output) stay within 5% of the most tokens/s any
rate of the sweep emitted. (A window that opens before the loop has
reached its steady state can hide a backlog that would grow; the token
rate cannot exceed what the pair emits at saturation.) The cell's traffic
file then fixes 0.8 of the knee as its ``rate``.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def grows(info: dict, rate: float, seconds: float) -> bool:
    """Whether the backlog grew over the window by more than a tenth of
    the requests it offered (and more than two)."""
    growth = info["backlog_close"] - info["backlog_open"]
    return growth > max(2.0, 0.1 * rate * seconds)


def knee(rows: list, mean_out: float):
    """The highest rate of ``rows`` (rate, backlog grew, tokens/s), in
    rising order, that is sustained: no growing backlog, and its offered
    output tokens/s within 5% of the sweep's most."""
    top = max(t for _, _, t in rows)
    best = None
    for rate, grew, _ in rows:
        if grew or rate * mean_out > 1.05 * top:
            break
        best = rate
    return best


def main() -> int:
    """Parse the arguments and print one line a rate, then the knee."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    import harness
    harness.checkout_caches()
    if not torch.cuda.is_available():
        print("sweep: needs a CUDA device", file=sys.stderr)
        return 2
    cell = harness.load_cell(args.workload)
    if cell.mix["loop"] != "open":
        print("sweep: the cell is not an open loop", file=sys.stderr)
        return 2
    import numpy as np
    import traffic
    mean_out = float(np.mean([b for _, b in traffic.Traffic(
        cell.mix, 0, 2)._block(traffic.BLOCK)]))
    rows = []
    for rate in sorted(float(r) for r in args.rates.split(",")):
        cell.mix = dict(cell.mix, rate=rate)
        out = harness.run_cell(cell, args.seed, args.seconds, False,
                               device="cuda",
                               process_start=time.perf_counter())
        info = out["info"]
        grew = grows(info, rate, args.seconds)
        rows.append((rate, grew, info["out_tokens_per_s"]))
        print(json.dumps({"workload": args.workload, "rate": rate,
                          "backlog_grows": grew, "correct": out["correct"],
                          "gap_max": out["checks"]["logit_gap_max"]["value"],
                          "info": info}), flush=True)
    k = knee(rows, mean_out)
    print(json.dumps({"workload": args.workload, "mean_out": mean_out,
                      "knee": k, "rate_at_0.8": None if k is None
                      else 0.8 * k}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
