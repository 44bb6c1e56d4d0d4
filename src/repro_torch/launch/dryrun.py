"""Dry-run: count every (arch x shape x mesh) step on the meta device and
report memory, FLOP, byte and roofline terms in H100 units.

The JAX package lowers and compiles each step for 512 host-faked
devices. Here the port's own step (the serving forward, or the training
loss, its backward and AdamW) runs on ``device="meta"``: no card, no
compiler and no allocation, so the dry-run needs no lock on a device
count and runs in any process. Counts are global and spread evenly over
the mesh's cards (:mod:`repro_torch.launch.roofline`); the argument size
per card is exact under the partition specs of
:mod:`repro_torch.launch.specs`.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-32b \\
      --shape decode_32k [--multi-pod] [--out out.json]
"""
from __future__ import annotations

import argparse
import dataclasses as dc
import json
import sys
import time
from typing import Dict, Optional

from repro_torch.configs import get_config, get_shape
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.roofline import (count_step, model_flops,
                                         roofline_report, tensor_bytes)
from repro_torch.launch.specs import leaves, make_specs
from repro_torch.models.sharding import shard_count

COUNT_KEYS = ("flops", "bytes", "output")


def _mixed_windows(cfg) -> bool:
    """Whether ``cfg`` mixes sliding-window and global attention layers."""
    return bool(cfg.window_size and cfg.global_every
                and cfg.global_every <= cfg.n_layers)


def _calibration_points(cfg):
    """Reduced-depth configs for the affine cost model total(L) = base +
    L*per_layer. Eager PyTorch counts every layer it runs, so the full
    depth could be counted as it is; counting two shallow copies and
    extrapolating is 10-30x faster on the meta device, and exact for a
    step that is affine in depth (the tests hold it so).

    The port's attention masks by the window only on windowed layers, so
    a model that mixes windowed and global layers (gemma3, hymba) costs
    one of two amounts a layer: its points are two windowed depths and
    one global layer ("fg"; the long-context variant stays off, as it is
    for the windowed model)."""
    if cfg.enc_dec:
        # vary decoder and encoder depth independently
        return [
            ("f11", dc.replace(cfg, n_layers=1, n_enc_layers=1)),
            ("f21", dc.replace(cfg, n_layers=2, n_enc_layers=1)),
            ("f12", dc.replace(cfg, n_layers=1, n_enc_layers=2)),
        ]
    if cfg.is_moe and cfg.moe_dense_layers:
        return [
            ("fa", dc.replace(cfg, n_layers=cfg.moe_dense_layers + 1)),
            ("fb", dc.replace(cfg, n_layers=cfg.moe_dense_layers + 2)),
        ]
    if _mixed_windows(cfg):
        local = dc.replace(cfg, global_every=0)
        return [("fa", dc.replace(local, n_layers=1)),
                ("fb", dc.replace(local, n_layers=2)),
                ("fg", dc.replace(cfg, n_layers=1, window_size=0,
                                  swa_variant_window=0))]
    return [("fa", dc.replace(cfg, n_layers=1)),
            ("fb", dc.replace(cfg, n_layers=2))]


def step_counts(cfg, shape, mesh, multi_pod) -> Dict[str, int]:
    """Global FLOPs, bytes moved and result bytes of one full-depth step
    (no extrapolation)."""
    step, specs = make_specs(cfg, shape, mesh, multi_pod=multi_pod)
    return count_step(step, specs.args)


def calibrated_counts(cfg, shape, mesh, multi_pod) -> Dict[str, int]:
    """Global (flops, bytes, output) of the full depth, extrapolated from
    steps counted at reduced depth (ints, so the extrapolation is exact)."""
    pts = _calibration_points(cfg)
    counts = {name: step_counts(c, shape, mesh, multi_pod)
              for name, c in pts}
    out = {}
    for key in COUNT_KEYS:
        if cfg.enc_dec:
            f11, f21, f12 = (counts["f11"][key], counts["f21"][key],
                             counts["f12"][key])
            d_dec, d_enc = f21 - f11, f12 - f11
            out[key] = (f11 + (cfg.n_layers - 1) * d_dec
                        + (cfg.n_enc_layers - 1) * d_enc)
        elif "fg" in counts:
            fa, fb, fg = (counts[n][key] for n in ("fa", "fb", "fg"))
            n_global = sum(cfg.layer_window(i) == 0
                           for i in range(cfg.n_layers))
            # base + n_local * (fb - fa) + n_global * (fg - base)
            base = 2 * fa - fb
            out[key] = (base + (cfg.n_layers - n_global) * (fb - fa)
                        + n_global * (fg - base))
        else:
            a_l = pts[0][1].n_layers
            fa, fb = counts["fa"][key], counts["fb"][key]
            out[key] = fa + (cfg.n_layers - a_l) * (fb - fa)
    return out


def argument_bytes(specs, mesh) -> int:
    """Per-card bytes of a step's arguments under their partition specs
    (every sharded dimension divides evenly: ``divisible_spec``)."""
    pspecs = leaves(specs.pspecs)
    return sum(tensor_bytes(t) // shard_count(pspecs[k], mesh)
               for k, t in leaves(specs.args).items())


def dryrun_report(cfg, shape, mesh, *, multi_pod: bool = False,
                  calibrate: bool = True, memo: Optional[Dict] = None
                  ) -> dict:
    """The roofline report of ``cfg`` at ``shape`` (an
    :class:`~repro_torch.configs.InputShape`) over ``mesh`` (any logical
    mesh with ``data`` and ``model`` axes), with ``t_compile_s`` (the
    specs' build) and, when ``calibrate``, ``t_calibrate_s``. The global
    counts do not depend on the mesh, so a caller running several meshes
    may pass one ``memo`` dict to count each (config, shape) once."""
    n_chips = mesh.size
    t0 = time.time()
    _, specs = make_specs(cfg, shape, mesh, multi_pod=multi_pod)
    arg_bytes = argument_bytes(specs, mesh)
    t_specs = time.time() - t0

    t1 = time.time()
    key = (cfg, shape, calibrate)
    memo = {} if memo is None else memo
    if key not in memo:
        memo[key] = (calibrated_counts if calibrate else step_counts)(
            cfg, shape, mesh, multi_pod)
    counts = memo[key]
    report = roofline_report(counts, n_chips, model_flops(cfg, shape), {
        "argument": arg_bytes, "output": counts["output"] // n_chips})
    if calibrate:
        report.update({"calibrated": True,
                       "t_calibrate_s": round(time.time() - t1, 2)})
    report["t_compile_s"] = round(t_specs, 2)
    return report


def run_one(arch: str, shape_name: str, multi_pod: bool,
            verbose: bool = True, calibrate: bool = True,
            memo: Optional[Dict] = None) -> dict:
    """The report of one cell of the production grid (see
    :func:`dryrun_report`), with ``arch``, ``shape``, ``mesh`` and
    ``status``."""
    mesh = make_production_mesh(multi_pod=multi_pod)
    report = dryrun_report(get_config(arch), get_shape(shape_name), mesh,
                           multi_pod=multi_pod, calibrate=calibrate,
                           memo=memo)
    report.update({"arch": arch, "shape": shape_name,
                   "mesh": "2x16x16" if multi_pod else "16x16",
                   "status": "ok"})
    if verbose:
        print(f"[{arch} x {shape_name} x {report['mesh']}] OK "
              f"specs={report['t_compile_s']:.1f}s "
              f"calibrate={report.get('t_calibrate_s', 0)}s")
        print(f"  memory: argument "
              f"{report['mem_argument_size_in_bytes'] / 2**30:.3f} "
              f"GiB/card, output "
              f"{report['mem_output_size_in_bytes'] / 2**30:.3f} GiB/card")
        print(f"  counts: flops={report['flops_global']:.3e} "
              f"bytes={report['bytes_per_device'] * mesh.size:.3e} "
              f"(global)")
        print(f"  roofline (H100): compute={report['t_compute']*1e3:.3f}ms "
              f"memory={report['t_memory']*1e3:.3f}ms "
              f"-> {report['bottleneck']}-bound "
              f"useful_flops={report['useful_flops_ratio']:.3f}")
    return report


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    report = run_one(args.arch, args.shape, args.multi_pod)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=2, default=str)
    return 0 if report["status"] == "ok" else 1


if __name__ == "__main__":
    sys.exit(main())
