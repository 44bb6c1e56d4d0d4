"""The dry-run over every (arch x shape x mesh), in-process: the
meta-device dry-run locks no device count, so one process runs every
cell, and counts each (arch, shape) once for both meshes.

  PYTHONPATH=src python -m repro_torch.launch.sweep --out results/dryrun \\
      [--multi-pod | --both-meshes] [--archs a,b] [--shapes x,y]

Each cell's report is written to ``<out>/<arch>__<shape>__<sp|mp>.json``
(a cell whose file exists is read back, so a sweep resumes), all of them
to ``<out>/summary.json``. A cell that raises is written with ``status:
"fail"`` and its error; the exit code is 1 if any cell failed.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback
from typing import Dict, Optional

from repro_torch.configs import ARCH_IDS, INPUT_SHAPES
from repro_torch.launch.dryrun import run_one

ASSIGNED = [a for a in ARCH_IDS if a not in ("llama3-8b", "qwen2-7b")]


def run_cell(arch: str, shape: str, multi_pod: bool, out_dir: str,
             memo: Optional[Dict] = None) -> dict:
    """One cell's report, read from its file if it exists, else run and
    written there (``status: "fail"`` with the error's last lines if the
    dry-run raises)."""
    tag = f"{arch}__{shape}__{'mp' if multi_pod else 'sp'}"
    out_file = os.path.join(out_dir, tag + ".json")
    if os.path.exists(out_file):
        with open(out_file) as f:
            return json.load(f)
    t0 = time.time()
    try:
        report = run_one(arch, shape, multi_pod, verbose=False, memo=memo)
    except Exception:   # a failing cell is recorded; the sweep goes on
        err = traceback.format_exc().strip().splitlines()
        report = {"arch": arch, "shape": shape,
                  "mesh": "2x16x16" if multi_pod else "16x16",
                  "status": "fail", "wall_s": round(time.time() - t0, 1),
                  "error": err[-3:]}
    with open(out_file, "w") as f:
        json.dump(report, f, indent=2, default=str)
    return report


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="results/dryrun")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--archs", default=",".join(ASSIGNED))
    ap.add_argument("--shapes", default=",".join(INPUT_SHAPES))
    args = ap.parse_args()
    os.makedirs(args.out, exist_ok=True)

    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    memo: Dict = {}
    results = []
    for arch in args.archs.split(","):
        for shape in args.shapes.split(","):
            for mp in meshes:
                t0 = time.time()
                r = run_cell(arch, shape, mp, args.out, memo)
                status = r.get("status")
                bn = r.get("bottleneck", "-")
                print(f"{arch:22s} {shape:12s} {'2x16x16' if mp else '16x16':8s}"
                      f" {status:4s} [{time.time()-t0:5.0f}s] bound={bn}",
                      flush=True)
                results.append(r)
    n_ok = sum(1 for r in results if r.get("status") == "ok")
    print(f"\n{n_ok}/{len(results)} OK")
    with open(os.path.join(args.out, "summary.json"), "w") as f:
        json.dump(results, f, indent=2, default=str)
    return 0 if n_ok == len(results) else 1


if __name__ == "__main__":
    sys.exit(main())
