"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py [--phases 1,2,3,4,5,6,7,8,9,10,11]

Phases (any failure exits non-zero; no phase's exception is swallowed):

1. environment and build: the card's name and power limit (the line of
   ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``), the
   torch and CUDA versions, and the ``nvcc`` build of every kernel
   (seconds and each kernel's registers / shared memory as ``ptxas``
   reports them); then, from ``cuobjdump -sass``, each kernel's count of
   tensor-core (HGMMA/HMMA), async-copy (UTMALDG/LDGSTS) and 16-byte load
   (LDG.E.128) instructions; fails unless the bf16 prefill kernel uses the
   tensor cores and the decode kernel loads 16-byte vectors;
2. each CUDA kernel against its plain PyTorch version on the card, at the
   shapes of the full-width llama3-8b main path, in fp32 (TF32 off) and
   bf16, and at qwen2-7b's (H 28, Kv 4) in bf16: max abs error beside its
   tolerance, kernel / plain / library times from CUDA events, and the
   least time the card could take; before them, a sweep of edge shapes
   (the paged dense families' heads at D = 128, G = 7, 8 and 12,
   included);
3. the main path: a Cronus PPI->CPI pair serving llama3-8b at full width
   (bf16, weights drawn on the card from seed 0) over the paged KV pool;
   every kernel's launch count is set to 0 just before the run and read
   just after, and each must have launched. One CPI decode step and one
   512-token prefill chunk of that run go under ``torch.profiler`` (left
   out of the timed steps): the top device operations, the device-busy
   share, and the device kernels each op launches;
4. parity: the same trace at full width cut to 2 layers, once with the
   kernels and once with the plain versions, logits and tokens compared;
5. the serving surface: each of cronus, disagg_hl, disagg_lh, dp and pp
   built by ``ServeSpec(executor="paged").build(device="cuda")`` around
   one full-width, full-depth bf16 model and serving phase 3's requests
   through ``InferenceService.run``; each must complete them all with
   both kernels launched (counts set to 0 before each run). Per approach:
   wall seconds, prefill tokens/s on the card, peak device memory and the
   ``aggregate`` keys, which are simulated-clock values (the engines'
   clocks are the A100/A10 device models). Then ``python -m
   repro_torch.launch.serve`` in a subprocess, which must complete 4/4;
6. the slot executor: Cronus through ``ServeSpec(executor="real")`` at
   full width and depth on the same requests (its CPI decode-step ms
   beside the paged executor's from phase 3), then slot against paged at
   2 layers on the same weights and trace, held to phase 4's rule;
7. the dense families at full width, weights drawn on the card from
   seed 0 in bf16, phase 3's requests, Cronus, kernel counts set to 0
   before each run: (7a) qwen2-7b, the paper's second model, at full
   depth through ``ServeSpec(arch="qwen2-7b", executor="paged")
   .build(device="cuda")`` with both kernels launched, then phase 4's
   parity at 2 layers and the launcher with ``--arch qwen2-7b`` in a
   subprocess; (7b) qwen3-32b (qk-norm) cut to 8 layers on the paged
   executor, then phase 4's parity at 2 layers; (7c) gemma3-27b (5 local layers of window 1024, 1 global)
   cut to 6 layers and (7d) qwen2-vl-72b (M-RoPE) cut to 4 layers on the
   slot executor, which the JAX package serves them on (its paged
   executor refuses both, as does the port's);
8. the MoE families on the slot executor (the paged executor refuses
   them in both packages), each drawn on the card from seed 0 in bf16 at
   full width (experts, top-k and shared experts kept) and cut in depth,
   served by Cronus on phase 3's requests through ``ServeSpec(arch=...,
   executor="real", max_slots=8, s_kv=2560, block_size=320)
   .build(device="cuda")`` (``build_cronus``'s 64-block floor then holds
   8 x 2560 positions) and freed before the next: (8a)
   deepseek-v2-236b (MoE + MLA) at 5 of 60 layers (1 dense + 4 MoE),
   (8b) kimi-k2-1t-a32b (MoE + GQA) at 2 of 61 (1 dense + 1 MoE); after
   each, (8c) its first MoE layer on 64 tokens, ``moe_block(exact=True)``
   against the dense oracle within a derived bf16 rule that a dropped
   expert fails by >= 10x (median over the tokens), and capacity mode's
   dropped pairs; then (8d)
   the launcher with ``--arch deepseek-v2-236b --smoke --executor real``
   in a subprocess. Phase 8 launches no kernel of the repo;
9. the SSM, hybrid and encoder-decoder families on the slot executor
   (the paged executor refuses them in both packages), each drawn on the
   card from seed 0 in bf16 at full width and full depth and served by
   Cronus on phase 3's requests through ``ServeSpec(arch=...,
   executor="real", max_slots=8, s_kv=2560, block_size=320)
   .build(device="cuda")``, freed before the next: (9a) mamba2-780m,
   (9b) hymba-1.5b, (9c) whisper-base (each request with encoder inputs
   ``[1500, 512]`` from numpy seed ``ENC_SEED``); after each, (9d) its
   PPI->CPI payload (SSM state; KV + SSM state; cross-KV + KV) moved by
   ``extract_kv``/``inject_kv`` into a fresh executor, which finishes the
   prefill and decodes 4 steps, held by phase 4's rule to one executor
   running the same chunks (whisper's payload with zeroed cross-KV must
   fail it); (9e) ``ssd_chunked`` against ``ssd_ref`` at mamba2's and
   hymba's head widths in fp32; (9f) the launcher with ``--arch
   hymba-1.5b --smoke --executor real`` in a subprocess. Phase 9
   launches neither kernel of the repo;
10. training through ``Trainer`` (bf16 compute on fp32 master weights
   and fp32 AdamW state, drawn on the card from seed 0; the batches of
   ``TokenDataset`` made on the host before the timed steps): (10a)
   llama3-8b at full width cut to 4 layers, 8 steps of 4 x 1024 tokens;
   (10b) the gradient at full width against the central difference of
   the loss along a random unit direction, in fp32 at 2 layers; (10c)
   mamba2-780m and whisper-base at full width and depth, 6 steps each,
   each training run followed by one step under ``torch.profiler``; (10d) a
   checkpoint saved after step 2 and loaded into a fresh trainer, whose
   next step must equal the uninterrupted run's bit for bit; (10e)
   ``python -m repro_torch.launch.train --steps 20`` in a subprocess.
   Each run prints its losses, grad norms, step ms, tokens/s and peak
   memory, and fails unless its losses and grad norms are finite, its
   last loss is below its first and neither kernel of the repo launched;
11. the dry-run (``repro_torch.launch.dryrun``): (11a) ``python -m
   repro_torch.launch.sweep`` over the twelve archs x four input shapes x
   both production meshes (16x16 and 2x16x16, counted in H100s) in a
   subprocess on the host's CPU (the meta device), one line a cell
   (argument GiB per card, t_compute and t_memory in ms, bottleneck,
   useful-FLOPs ratio), all 96 ``ok``; (11b) llama3-8b on a one-card mesh
   (decode of 8 rows over 32768 positions, a prefill of 8192 tokens),
   weights drawn on the card from seed 0 in the specs' dtypes: the card's
   ``memory_allocated`` for the weights, zeroed cache and inputs within
   1% of the predicted argument bytes, ``FlopCounterMode`` over the run
   on the card equal to the calibrated count, and the median of 5
   synchronised forwards at least 0.9 x the larger roofline term (the
   ratio printed). Phase 11 launches neither kernel of the repo.

The line before the last is a JSON object with one entry per kernel
(``launches`` counts phases 3, 5 and 7's paged runs; ``qwen2_7b`` holds
phase 2's reading at qwen2-7b's heads); the last line is ``{"ok": true,
"device": {...}}``. Without a CUDA device the script exits with code 1
and prints no result.
"""
from __future__ import annotations

import argparse
import collections
import dataclasses
import gc
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# published peaks of one H100 SXM (NVIDIA data sheet, dense)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}

# tolerances of kernel vs plain version on the same inputs, elementwise:
# |got - want| <= RTOL * |want| + ATOL.
# fp32: both sum up to 2048 products in fp32 in a different order (the
# repo's kernel tests allow 2e-5 absolute).
# bf16: both compute in fp32 from the same bf16 inputs, whose fp32 results
# differ by ~1e-6 of the row's scale, and round once to bf16. The two
# roundings then land at most one bf16 ulp apart, and one ulp is at most
# 2^-7 of the value (8 significant bits); 2^-12 covers entries near 0. So
# each element is held to its own size: on a 2048-key row (|out| ~0.04) a
# dropped 64-key tile or a wrong rescale of acc (~6e-3) fails by 20x.
TOL = {"float32": (0.0, 2e-5), "bfloat16": (2.0 ** -7, 2.0 ** -12)}


def _tol_text(dname):
    rtol, atol = TOL[dname]
    return f"tol {rtol:.3g}*|want| + {atol:.3g}"


def _errors(got, want, dname):
    """Max abs error, and the max over elements of |got - want| / tolerance
    (the check passes iff it is <= 1)."""
    rtol, atol = TOL[dname]
    want = want.float()
    err = (got.float() - want).abs()
    return err.max().item(), (err / (rtol * want.abs() + atol)).max().item()

# phase 4: bf16 logits of the two runs may differ by a few bf16 ulps of a
# logit of magnitude 4-8 (ulp 2^-5): 4 ulps.
LOGIT_TOL = 0.125

# requests served by phases 3 and 4
N_REQUESTS = 8
# numpy seed of the encoder inputs of phase 9c's whisper requests
ENC_SEED = 9

# (H, Kv) at D = 128 of the dense families served on the paged path:
# qwen2-7b and deepseek-coder-33b (G = 7), qwen3-32b (G = 8),
# starcoder2-15b (G = 12)
FAMILY_GQA = ((28, 4), (56, 8), (64, 8), (48, 4))


def log(*args):
    """Print and flush (the output is read after the run)."""
    print(*args, flush=True)


def _fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


# ---------------------------------------------------------------------------
# phase 1
# ---------------------------------------------------------------------------

def phase_env_build(torch):
    """Print the card and versions; build every kernel."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    log("[phase 1] nvidia-smi --query-gpu=name,power.limit:")
    log(smi)
    log(f"[phase 1] torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} device "
        f"{torch.cuda.get_device_name(0)}")
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    logs = build.build_all()
    log(f"[phase 1] kernels built in {time.perf_counter() - t0:.2f} s "
        f"({len(logs)} compiled, {len(build.SOURCES) - len(logs)} cached)")
    for source, text in logs.items():
        for line in text.splitlines():
            if ("registers" in line or "Compiling entry" in line
                    or "Performance Loss" in line):
                log(f"[phase 1]   {source}: {line.strip()}")
    _sass_check(build)


# SASS opcodes that show the design: tensor cores, async copies, 16-byte
# global loads (any LDG with a .128 width)
SASS_KINDS = {"HGMMA": r"\bHGMMA\.", "HMMA": r"\bHMMA\.",
              "UTMALDG": r"\bUTMALDG\b", "LDGSTS": r"\bLDGSTS\b",
              "LDG.E.128": r"\bLDG\.E(\.[A-Z0-9_]+)*\.128\b"}


def _tool(name):
    for path in (shutil.which(name), f"/usr/local/cuda/bin/{name}"):
        if path and os.path.exists(path):
            return path
    return None


def _sass_counts(lib):
    """{kernel name: {opcode kind: count}} from ``cuobjdump -sass``."""
    text = subprocess.run([_tool("cuobjdump"), "-sass", str(lib)],
                          capture_output=True, text=True, timeout=300,
                          check=True).stdout
    counts, fn = {}, None
    for line in text.splitlines():
        head = re.match(r"\s*Function : (\S+)", line)
        if head:
            fn = head.group(1)
            counts[fn] = dict.fromkeys(SASS_KINDS, 0)
        elif fn is not None:
            for kind, pat in SASS_KINDS.items():
                if re.search(pat, line):
                    counts[fn][kind] += 1
    names = list(counts)
    filt = _tool("cu++filt") or _tool("c++filt")
    if filt and names:
        out = subprocess.run([filt], input="\n".join(names),
                             capture_output=True, text=True, timeout=60,
                             check=True).stdout.splitlines()
        if len(out) == len(names):
            names = [_short_name(n) for n in out]
    return dict(zip(names, counts.values()))


def _short_name(demangled):
    """``void ns::kernel<(int)128>(args)`` -> ``kernel<128>``."""
    n = re.sub(r"^void |\(anonymous namespace\)::|<unnamed>::|cronus::|"
               r"\((int|unsigned int)\)", "", demangled)
    depth = 0
    for i, ch in enumerate(n):
        depth += (ch == "<") - (ch == ">")
        if ch == "(" and depth == 0:
            return n[:i]
    return n


def _sass_check(build):
    """Print each kernel's instruction counts; fail unless the bf16
    prefill kernel runs on the tensor cores and the decode kernel loads
    16-byte vectors."""
    if _tool("cuobjdump") is None:
        _fail("cuobjdump not found: cannot show the kernels' instructions")
    tc = {}
    for source in build.SOURCES:
        per_fn = _sass_counts(build.library_path(source))
        total = {k: sum(c[k] for c in per_fn.values()) for k in SASS_KINDS}
        log(f"[phase 1] SASS {source}: {len(per_fn)} kernels, {total}")
        for name, c in per_fn.items():
            text = " ".join(f"{k} {v}" for k, v in c.items() if v)
            log(f"[phase 1]   {name}: {text or '-'}")
        tc[source] = per_fn
    prefill = [c for n, c in tc["chunked_prefill_attention.cu"].items()
               if re.search(r"tc::kernel|2tc6kernel", n)]
    if len(prefill) != 3:
        _fail(f"expected the bf16 prefill kernel at 3 head dims, found "
              f"{len(prefill)}")
    if not prefill or not all(c["HMMA"] + c["HGMMA"] > 0 for c in prefill):
        _fail("the bf16 prefill kernel has no tensor-core instruction")
    if not any(c["LDG.E.128"] > 0
               for c in tc["paged_attention.cu"].values()):
        _fail("the decode kernel has no 16-byte global load")


# ---------------------------------------------------------------------------
# phase 2
# ---------------------------------------------------------------------------

# SM cycles (~0.5 ms) that the card spins before each timed launch, so the
# host has queued ``fn``'s kernels before the start event is reached
HOLD_CYCLES = 1_000_000


def _time_ms(torch, fn, flush, iters=20):
    """Median device time of ``fn`` from CUDA events, L2 flushed before
    each launch (the main path finds every layer's K/V cold). Without the
    spin before the start event, the time would include the host's time
    to enqueue ``fn`` whenever that outlasts the flush."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(iters):
        flush.zero_()
        torch.cuda._sleep(HOLD_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def _decode_inputs(torch, dtype, rng, h=32, kvh=8):
    """Full-width decode step: B=8, H=32, Kv=8 (llama3-8b; qwen2-7b: 28 /
    4), D=128, page=16, ragged context up to 2048 with one ctx=0 lane,
    trash-padded tables."""
    b, d, page, max_pages = 8, 128, 16, 128
    ctx = np.array([2048, 0, 1, 17, 300, 1000, 1537, 777], np.int32)
    n_pages = b * max_pages
    trash = n_pages
    perm = rng.permutation(n_pages)
    tables = np.full((b, max_pages), trash, np.int32)
    at = 0
    for i, c in enumerate(ctx):
        live = -(-int(c) // page)
        tables[i, :live] = perm[at:at + live]
        at += live
    dev = "cuda"
    q = torch.from_numpy(rng.standard_normal((b, h, d), np.float32))
    kp = torch.from_numpy(rng.standard_normal((n_pages + 1, page, kvh, d),
                                              np.float32))
    vp = torch.from_numpy(rng.standard_normal((n_pages + 1, page, kvh, d),
                                              np.float32))
    args = (q.to(dev, dtype), kp.to(dev, dtype), vp.to(dev, dtype),
            torch.from_numpy(tables).to(dev), torch.from_numpy(ctx).to(dev))
    elt = args[0].element_size()
    nbytes = (2 * int(ctx.sum()) * kvh * d * elt      # live K/V rows
              + 2 * b * h * d * elt                    # q, out
              + 4 * (b + int(np.ceil(ctx / page).sum())))  # lens, tables
    flops = 4 * int(ctx.sum()) * h * d
    return args, nbytes, flops


def _prefill_inputs(torch, dtype, rng, window, h=32, kvh=8):
    """Full-width prefill chunk: B=1, C=512, H=32, Kv=8 (llama3-8b;
    qwen2-7b: 28 / 4), D=128, S=2048, the last chunk of a 2048-token
    prompt."""
    b, c, d, s = 1, 512, 128, 2048
    q_pos = (s - c + np.arange(c, dtype=np.int32))[None]
    kv_pos = np.arange(s, dtype=np.int32)[None]
    dev = "cuda"
    q = torch.from_numpy(rng.standard_normal((b, c, h, d), np.float32))
    k = torch.from_numpy(rng.standard_normal((b, s, kvh, d), np.float32))
    v = torch.from_numpy(rng.standard_normal((b, s, kvh, d), np.float32))
    args = (q.to(dev, dtype), k.to(dev, dtype), v.to(dev, dtype),
            torch.from_numpy(q_pos).to(dev), torch.from_numpy(kv_pos).to(dev))
    valid = (kv_pos[:, None, :] <= q_pos[:, :, None]) & (kv_pos[:, None, :] >= 0)
    if window > 0:
        valid &= kv_pos[:, None, :] > q_pos[:, :, None] - window
    elt = args[0].element_size()
    nbytes = (2 * b * c * h * d * elt + 2 * b * s * kvh * d * elt
              + 4 * b * (c + s))
    flops = 4 * int(valid.sum()) * h * d       # the pairs this data needs
    return args, nbytes, flops, torch.from_numpy(valid).to(dev)


def _bound(nbytes, flops, dtype_name):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _sweep(torch):
    """Kernel vs plain version at the small shapes of the CPU tests (all
    head dims, GQA ratios and page sizes the kernels take, ragged C and S,
    padded query rows, ctx=0 lanes and contexts past the table), then at
    shapes that exercise the redesigned kernels' edges: decode contexts of
    several splits with a ragged last split, contexts shorter than one
    split, pages of 4/8/16 and G of 1, 2, 3, 4, 8 and 16; prefill tiles the
    skip rule drops (a padded C tail like the executor's buckets, a
    kv_pos = -1 tail, window 256); and the heads of the dense families on
    the paged path, at D = 128: H / Kv = 28 / 4 and 56 / 8 (G = 7: the
    group does not divide the 128-row prefill tile), 64 / 8 (G = 8,
    qwen3-32b's) and 48 / 4 (G = 12: two decode head passes). Returns the
    failures: an element outside its tolerance."""
    from repro_torch.kernels import (chunked_prefill_attention, ops,
                                     paged_attention)
    worst, ratio, where, n = {}, {}, {}, 0

    def note(dname, got, want, case):
        err, r = _errors(got, want, dname)
        worst[dname] = max(worst.get(dname, 0.0), err)
        if not r <= ratio.get(dname, 0.0):
            ratio[dname], where[dname] = r, case

    for dname in ("float32", "bfloat16"):
        dtype = getattr(torch, dname)
        rng = np.random.default_rng(1)

        def t(shape):
            return torch.from_numpy(rng.standard_normal(
                shape, np.float32)).to("cuda", dtype)

        def prefill(q_pos, kv_pos, h, kv, d, window):
            (b, c), s = q_pos.shape, kv_pos.shape[1]
            args = (t((b, c, h, d)), t((b, s, kv, d)), t((b, s, kv, d)),
                    torch.from_numpy(q_pos.astype(np.int32)).cuda(),
                    torch.from_numpy(kv_pos.astype(np.int32)).cuda())
            got = chunked_prefill_attention.chunked_prefill_attention(
                *args, window=window)
            want = ops.chunked_prefill_attention(*args, window=window,
                                                 use_kernels=False)
            note(dname, got, want, f"prefill q_pos {q_pos.shape} k/v "
                 f"{tuple(args[1].shape)} window {window}")

        for b, c, h, kv, d, s in [(1, 8, 4, 4, 32, 32), (2, 16, 8, 2, 64, 64),
                                  (2, 8, 8, 1, 64, 64), (1, 32, 4, 4, 128, 32),
                                  (2, 13, 4, 2, 64, 50), (1, 300, 32, 8, 128,
                                                          700)]:
            for window in (0, 8):
                ctx = np.arange(b) * 5 + 3
                q_pos = ctx[:, None] + np.arange(c)[None]
                q_pos[0, c // 2:c // 2 + 3] = -1          # padded rows
                kv_pos = np.where(np.arange(s)[None] < (ctx + c)[:, None],
                                  np.arange(s)[None], -1)
                prefill(q_pos, kv_pos, h, kv, d, window)
                n += 1
        # an executor bucket: 300 real queries of a 512 chunk after 700
        # cached tokens, S padded to 1024 with kv_pos = -1, at windows 0
        # and 256 (the window drops the leading tiles)
        q_pos = np.where(np.arange(512) < 300, 700 + np.arange(512), -1)[None]
        kv_pos = np.where(np.arange(1024) < 1000, np.arange(1024), -1)[None]
        for h, kv, d in [(32, 8, 128), (8, 8, 64), (16, 1, 32)]:
            for window in (0, 256):
                prefill(q_pos, kv_pos, h, kv, d, window)
                n += 1
        # G = 7 (18 queries in 126 of a tile's 128 rows), 8 and 12 (10 in
        # 120) at D = 128, C = 512, S = 2048: 400 real queries after 1500
        # cached tokens, so a padded C tail and a kv_pos = -1 tail
        q_pos = np.where(np.arange(512) < 400, 1500 + np.arange(512), -1)[None]
        kv_pos = np.where(np.arange(2048) < 1900, np.arange(2048), -1)[None]
        for h, kv in FAMILY_GQA:
            for window in (0, 256):
                prefill(q_pos, kv_pos, h, kv, 128, window)
                n += 1

        for b, h, kv, d, pages, page, maxp, cl in [
                (2, 8, 2, 64, 16, 8, 4, None), (3, 4, 4, 32, 8, 16, 3, None),
                (1, 8, 1, 128, 32, 8, 8, None), (4, 4, 2, 32, 24, 4, 6, None),
                (4, 4, 2, 32, 24, 8, 6, None), (5, 32, 8, 128, 40, 16, 8, None),
                # several splits, a ragged last one, ctx=0, past the table
                (5, 8, 8, 128, 400, 16, 64, [1000, 700, 513, 0, 1033]),
                # contexts shorter than one split, around its edge
                (5, 16, 8, 64, 400, 8, 96, [1, 17, 255, 256, 257]),
                (4, 32, 8, 128, 600, 4, 200, [800, 799, 3, 0]),
                (3, 64, 8, 32, 200, 16, 40, [640, 300, 90]),
                (2, 24, 8, 64, 200, 16, 40, [600, 31]),        # G = 3
                (2, 32, 2, 128, 200, 16, 40, [640, 257])] + [  # G = 16
                # G = 7, 8 and 12: several splits, one shorter than a
                # split, and ctx = 0
                (3, h, kv, 128, 400, 16, 64, [1000, 100, 0])
                for h, kv in FAMILY_GQA]:
            bt = rng.integers(0, pages, (b, maxp)).astype(np.int32)
            if cl is None:  # full table, ctx=0, past the table, then ragged
                cl = np.concatenate([[maxp * page, 0, maxp * page + 5],
                                     rng.integers(1, maxp * page, b)])[:b]
            args = (t((b, h, d)), t((pages, page, kv, d)),
                    t((pages, page, kv, d)), torch.from_numpy(bt).cuda(),
                    torch.from_numpy(np.asarray(cl, np.int32)).cuda())
            got = paged_attention.paged_decode_attention(*args)
            want = ops.paged_decode_attention(*args, use_kernels=False)
            note(dname, got, want, f"decode q {tuple(args[0].shape)} pages "
                 f"{tuple(args[1].shape)} ctx {list(cl)}")
            n += 1
    torch.cuda.synchronize()
    log(f"[phase 2] small-shape sweep: {n} cases, worst "
        + ", ".join(f"{k}: max_abs_err {worst[k]:.3e}, max err/tol "
                    f"{ratio[k]:.3f} ({_tol_text(k)}) at {where[k]}"
                    for k in worst))
    return [f"small-shape sweep {k}: an element is {r:.3f}x its tolerance"
            for k, r in ratio.items() if not r <= 1.0]


def _decode_case(torch, dname, args, nbytes, flops, flush, tag):
    """Decode kernel vs plain version on ``args``: checked, timed, printed;
    returns its JSON row and whether it disagrees."""
    from repro_torch.kernels import ops, paged_attention
    got = paged_attention.paged_decode_attention(*args)
    want = ops.paged_decode_attention(*args, use_kernels=False)
    torch.cuda.synchronize()
    err, ratio = _errors(got, want, dname)
    zero_lane = got[1].float().abs().max().item()
    k_ms = _time_ms(torch, lambda: paged_attention.paged_decode_attention(
        *args), flush)
    p_ms = _time_ms(torch, lambda: ops.paged_decode_attention(
        *args, use_kernels=False), flush)
    b_ms, b_by = _bound(nbytes, flops, dname)
    log(f"[phase 2] {tag}paged_decode {dname}: max_abs_err {err:.3e} max "
        f"err/tol {ratio:.3f} ({_tol_text(dname)}) ctx=0 lane max|out| "
        f"{zero_lane} kernel_ms {k_ms:.4f} plain_ms {p_ms:.4f} "
        f"library_ms none (needs a gather) bound_ms {b_ms:.4f} ({b_by})")
    row = dict(max_abs_err=err, ms=k_ms, plain_ms=p_ms, bound_ms=b_ms,
               bound_by=b_by, library_ms=None)
    return row, not (ratio <= 1.0) or zero_lane != 0.0


def _prefill_case(torch, dname, args, nbytes, flops, valid, window, flush,
                  tag):
    """Prefill kernel vs plain version on ``args``, and SDPA with the same
    mask and GQA grouping as the library's yardstick: checked, timed,
    printed; returns its JSON row and whether it disagrees."""
    from repro_torch.kernels import chunked_prefill_attention, ops
    got = chunked_prefill_attention.chunked_prefill_attention(
        *args, window=window)
    want = ops.chunked_prefill_attention(*args, window=window,
                                         use_kernels=False)
    torch.cuda.synchronize()
    err, ratio = _errors(got, want, dname)
    k_ms = _time_ms(
        torch, lambda: chunked_prefill_attention
        .chunked_prefill_attention(*args, window=window), flush)
    p_ms = _time_ms(torch, lambda: ops.chunked_prefill_attention(
        *args, window=window, use_kernels=False), flush)
    q, k, v = (t.transpose(1, 2) for t in args[:3])
    mask = valid[:, None]

    def sdpa():
        return torch.nn.functional.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, enable_gqa=True)
    lib_err = (sdpa().transpose(1, 2).float()
               - want.float()).abs().max().item()
    l_ms = _time_ms(torch, sdpa, flush)
    b_ms, b_by = _bound(nbytes, flops, dname)
    log(f"[phase 2] {tag}chunked_prefill {dname} window={window}: "
        f"max_abs_err {err:.3e} max err/tol {ratio:.3f} "
        f"({_tol_text(dname)}) kernel_ms {k_ms:.4f} plain_ms "
        f"{p_ms:.4f} library_ms {l_ms:.4f} (sdpa err {lib_err:.2e}) "
        f"bound_ms {b_ms:.4f} ({b_by})")
    row = dict(max_abs_err=err, ms=k_ms, plain_ms=p_ms, bound_ms=b_ms,
               bound_by=b_by, library_ms=l_ms)
    return row, not (ratio <= 1.0)


def phase_kernels(torch):
    """Each kernel against its plain version at llama3-8b's full-width
    shapes (fp32 and bf16) and at qwen2-7b's (bf16); returns the bf16
    llama3-8b rows of the kernels JSON line (without launches), each with
    its qwen2-7b reading under ``"qwen2_7b"``. Every check runs, and every
    time is taken, before a failure ends the phase."""
    failures = _sweep(torch)
    flush = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device="cuda")
    rows = {}
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        rng = np.random.default_rng(0)
        row, bad = _decode_case(torch, dname, *_decode_inputs(
            torch, dtype, rng), flush, "")
        if bad:
            failures.append(f"paged_decode {dname} disagrees with its plain "
                            f"version")
        if dtype == torch.bfloat16:
            rows["paged_decode_attention"] = row
        for window in (0, 256):
            row, bad = _prefill_case(torch, dname, *_prefill_inputs(
                torch, dtype, rng, window), window, flush, "")
            if bad:
                failures.append(f"chunked_prefill {dname} window={window} "
                                f"disagrees with its plain version")
            if dtype == torch.bfloat16 and window == 0:
                rows["chunked_prefill_attention"] = row
    # the same contexts and chunk at qwen2-7b's heads (H 28, Kv 4: G = 7)
    rng = np.random.default_rng(0)
    tag = "qwen2-7b H 28 Kv 4: "
    row, bad = _decode_case(torch, "bfloat16", *_decode_inputs(
        torch, torch.bfloat16, rng, h=28, kvh=4), flush, tag)
    rows["paged_decode_attention"]["qwen2_7b"] = row
    if bad:
        failures.append("paged_decode bfloat16 at qwen2-7b's heads "
                        "disagrees with its plain version")
    row, bad = _prefill_case(torch, "bfloat16", *_prefill_inputs(
        torch, torch.bfloat16, rng, 0, h=28, kvh=4), 0, flush, tag)
    rows["chunked_prefill_attention"]["qwen2_7b"] = row
    if bad:
        failures.append("chunked_prefill bfloat16 at qwen2-7b's heads "
                        "disagrees with its plain version")
    del flush
    torch.cuda.empty_cache()
    if failures:
        _fail("; ".join(failures))
    dec, pre = rows["paged_decode_attention"], rows[
        "chunked_prefill_attention"]
    log(f"[phase 2] bf16 bars: prefill kernel_ms {pre['ms']:.4f} <= SDPA "
        f"{pre['library_ms']:.4f}: {pre['ms'] <= pre['library_ms']}; decode "
        f"kernel_ms {dec['ms']:.4f} <= 0.05 and < plain {dec['plain_ms']:.4f}:"
        f" {dec['ms'] <= 0.05 and dec['ms'] < dec['plain_ms']}")
    return rows


# ---------------------------------------------------------------------------
# phases 3 and 4: the main path
# ---------------------------------------------------------------------------

def make_requests(n, vocab, seed=0, output_len=32, enc_shape=None):
    """``n`` prompts of 256-2048 tokens from a numpy seed, all at t=0;
    with ``enc_shape`` (an encoder-decoder's ``(frames, d_model)``), each
    also carries encoder-input embeddings from a second numpy seed, so
    the prompts stay the same."""
    from repro_torch.core.request import Request
    rng = np.random.default_rng(seed)
    enc_rng = np.random.default_rng(ENC_SEED)
    lens = rng.integers(256, 2049, n)
    return [Request(req_id=f"r{i}",
                    prompt=rng.integers(0, vocab, int(n_tok)).astype(
                        np.int32),
                    output_len=output_len, arrival=0.0,
                    enc_emb=None if enc_shape is None else
                    enc_rng.standard_normal(enc_shape).astype(np.float32))
            for i, n_tok in enumerate(lens)]


def build_pair(cfg, factory, executor="paged"):
    """The slice's Cronus pair, A100 CPI + A10 PPI clocks: on the paged
    executor, 16 slots and 2048 KV blocks of 16 tokens an engine; on the
    slot executor, ``SLOTS`` slots of ``S_KV`` positions and the same KV
    budget in blocks."""
    from repro_torch.serving import hardware
    from repro_torch.serving.simulator import build_system
    kw = (dict(max_slots=16, num_kv_blocks=2048) if executor == "paged"
          else dict(max_slots=SLOTS, num_kv_blocks=SLOTS * -(-S_KV // 16)))
    return build_system("cronus", cfg, hardware.A100, hardware.A10,
                        executor_factory=factory, executor=executor,
                        block_size=16, max_batched_tokens=512, **kw)


# one executor call run under ``torch.profiler``: its label, its kind
# ("prefill" or "decode"), the profiler, its wall seconds and the launches
# of each op in it
Profile = collections.namedtuple("Profile",
                                 "label kind prof wall_s launches")


class Recorder:
    """Wraps one engine's executor: kernel launches, wall time (host clock
    after a synchronise) and, optionally, every emitted logits row. With
    ``profile``, one decode step (``{"decode": n}``: the n-th) and one
    prefill chunk (``{"prefill": (tokens, n)}``: the n-th of that many
    tokens) run under ``torch.profiler`` and are kept in
    ``self.profiles``; their launches count, their times and tokens do
    not."""

    def __init__(self, torch, name, engine, keep_logits=False,
                 profile=None):
        from repro_torch.kernels import (chunked_prefill_attention,
                                         paged_attention)
        ex = engine.executor
        self.name, self.ex = name, ex
        self.launch = {"prefill": 0, "decode": 0}
        self.prefill_s, self.prefill_tokens = 0.0, 0
        self.chunk_s = {}       # chunk tokens -> [seconds] (unprofiled)
        self.decode_s, self.decode_steps, self.step_s = 0.0, 0, []
        # every call, profiled or not: prefill chunks, decode steps, lanes
        self.calls = {"prefill": 0, "decode": 0, "lanes": 0}
        self.profiled_s = 0.0   # in profiled calls, with the profiler's own
        self.rows = {}          # (req_id, token index) -> (logits, token)
        self.profiles = []
        want = profile or {}
        calls = {"decode": 0}   # calls so far, by kind or chunk tokens
        p_mod, d_mod = chunked_prefill_attention, paged_attention
        orig_prefill, orig_decode = ex.prefill_chunk, ex.decode

        def counts():
            return p_mod.launches, d_mod.launches

        def call(kind, label, fn):
            """Run ``fn`` timed, or under the profiler when ``label`` is
            given; returns its result and its seconds (None if profiled)."""
            before, t0 = counts(), time.perf_counter()
            if label is None:
                out = fn()
                torch.cuda.synchronize()
                secs = time.perf_counter() - t0
            else:
                out, prof, wall = self._profiled(torch, fn)
                self.profiled_s += time.perf_counter() - t0
                secs = None
            after = counts()
            self.launch["prefill"] += after[0] - before[0]
            self.launch["decode"] += after[1] - before[1]
            if label is not None:
                self.profiles.append(Profile(label, kind, prof, wall, {
                    "chunked_prefill_attention": after[0] - before[0],
                    "paged_decode_attention": after[1] - before[1]}))
            return out, secs

        def req(slot):
            r = engine.slots[slot]
            return r.req_id, len(r.generated)

        def prefill_chunk(slot, tokens, ctx_len, completes, enc_emb=None):
            n = len(tokens)
            calls[n] = calls.get(n, 0) + 1
            self.calls["prefill"] += 1
            label = None
            if want.get("prefill") == (n, calls[n]):
                label = (f"{name} prefill chunk of {n} tokens after "
                         f"{ctx_len} cached")
            tok, secs = call("prefill", label, lambda: orig_prefill(
                slot, tokens, ctx_len, completes, enc_emb))
            if secs is not None:
                self.prefill_s += secs
                self.prefill_tokens += n
                self.chunk_s.setdefault(n, []).append(secs)
            if keep_logits and completes:
                self.rows[req(slot)] = (ex.last_logits[0].copy(), tok)
            return tok

        def decode(slot_tokens, slot_lens):
            calls["decode"] += 1
            self.calls["decode"] += 1
            self.calls["lanes"] += len(slot_tokens)
            label = None
            if want.get("decode") == calls["decode"]:
                label = (f"{name} decode step {calls['decode']} "
                         f"({len(slot_tokens)} lanes, contexts "
                         f"{sorted(slot_lens.values())})")
            out, secs = call("decode", label,
                             lambda: orig_decode(slot_tokens, slot_lens))
            if secs is not None:
                self.decode_s += secs
                self.decode_steps += 1
                self.step_s.append(secs)
            if keep_logits:
                for i, s in enumerate(sorted(slot_tokens)):
                    self.rows[req(s)] = (ex.last_logits[i].copy(), out[s])
            return out

        ex.prefill_chunk, ex.decode = prefill_chunk, decode

    @staticmethod
    def _profiled(torch, fn):
        """Run ``fn`` once under the profiler (CPU and CUDA activity),
        between two synchronises; return its result, the profiler and the
        wall seconds."""
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        return out, prof, wall


def _counted(torch, run):
    """Set every kernel count to 0, call ``run()`` between two
    synchronises and read the counts; returns its result, the wall seconds
    (host clock) and the launches per kernel."""
    from repro_torch.kernels import chunked_prefill_attention, paged_attention
    chunked_prefill_attention.launches = 0
    paged_attention.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return res, wall, {"chunked_prefill_attention":
                       chunked_prefill_attention.launches,
                       "paged_decode_attention": paged_attention.launches}


def run_trace(torch, cfg, factory, n_requests, keep_logits=False,
              profile=None, executor="paged"):
    """Serve ``n_requests`` through a fresh pair; returns the system, the
    per-engine recorders, the aggregate metrics, the wall seconds, the
    launches per kernel over the run and the requests. ``profile`` maps
    an engine ("ppi"/"cpi") to its Recorder's profile."""
    system = build_pair(cfg, factory, executor)
    recs = [Recorder(torch, role, e, keep_logits,
                     (profile or {}).get(role))
            for role, e in (("ppi", system.ppi), ("cpi", system.cpi))]
    reqs = make_requests(n_requests, cfg.vocab_size)
    res, wall, launches = _counted(torch, lambda: system.run(reqs))
    return system, recs, res, wall, launches, reqs


def phase_main_path(torch, n_requests=N_REQUESTS):
    """Full-width llama3-8b Cronus serving; returns launches per kernel."""
    from repro_torch.configs import get_config
    from repro_torch.serving.api import paged_executor_factory
    cfg = dataclasses.replace(get_config("llama3-8b"), dtype="bfloat16")
    t0 = time.perf_counter()
    factory = paged_executor_factory(cfg, device="cuda")
    torch.cuda.synchronize()
    log(f"[phase 3] {cfg.name}: {cfg.n_layers} layers d_model {cfg.d_model} "
        f"heads {cfg.n_heads}/{cfg.n_kv_heads} d_ff {cfg.d_ff} vocab "
        f"{cfg.vocab_size} {cfg.dtype}; weights drawn on the card in "
        f"{time.perf_counter() - t0:.2f} s")
    torch.cuda.reset_peak_memory_stats()

    # one CPI decode step and the PPI's first full prefill chunk run under
    # the profiler; their launches count, their times and tokens do not
    system, recs, res, wall, launches, reqs = run_trace(
        torch, cfg, factory, n_requests, profile=PROFILE)

    ppi, cpi = recs
    splits = [(r.req_id, r.input_len, r.partial_len) for r in reqs]
    n_split = sum(0 < p < n for _, n, p in splits)
    prefill_s = ppi.prefill_s + cpi.prefill_s
    prefill_tok = ppi.prefill_tokens + cpi.prefill_tokens
    step_ms = 1e3 * cpi.decode_s / max(cpi.decode_steps, 1)
    chunk_tokens = PROFILE["ppi"]["prefill"][0]
    chunks = ppi.chunk_s.get(chunk_tokens, []) + cpi.chunk_s.get(
        chunk_tokens, [])
    profiled_s = ppi.profiled_s + cpi.profiled_s
    log(f"[phase 3] completed {res['completed']}/{n_requests} in "
        f"{wall:.3f} s wall, {wall - profiled_s:.3f} s without the "
        f"profiled calls ({profiled_s:.3f} s with the profiler's start and "
        f"stop); (input_len, partial_len): "
        f"{[(n, p) for _, n, p in splits]}")
    log(f"[phase 3] prefill {prefill_tok} tokens in {prefill_s:.3f} s "
        f"= {prefill_tok / max(prefill_s, 1e-9):.1f} tokens/s; CPI decode "
        f"{cpi.decode_steps} steps, mean {step_ms:.3f} ms/step (profiled "
        f"calls left out); max_memory_allocated "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    for rec in recs:
        log(f"[phase 3] {rec.name}: kernel launches {rec.launch}, prefill "
            f"{rec.prefill_tokens} tokens, decode {rec.decode_steps} steps "
            f"timed, {len(rec.profiles)} calls profiled")
    log(f"[phase 3] launches over the run: {launches}")
    if res["completed"] != n_requests:
        _fail(f"completed {res['completed']} of {n_requests}")
    if n_split == 0:
        _fail("no request was split between PPI and CPI")
    if ppi.launch["prefill"] == 0 or cpi.launch["prefill"] == 0:
        _fail("the prefill kernel did not run on both engines")
    if cpi.launch["decode"] == 0:
        _fail("the decode kernel did not run on the CPI")
    if min(launches.values()) == 0:
        _fail(f"a kernel of the path never launched: {launches}")

    # where a step's time goes, and how many device kernels each op
    # launches, from the profiled calls
    profiles = [p for rec in recs for p in rec.profiles]
    if not profiles:
        log("[phase 3] profile: no call matched; not measured")
    unprofiled = {
        "decode": (statistics.median(cpi.step_s) if cpi.step_s else None,
                   "CPI decode step"),
        "prefill": (statistics.median(chunks) if chunks else None,
                    f"{chunk_tokens}-token chunk")}
    n_dev, n_op = dict.fromkeys(KERNELS, 0), dict.fromkeys(KERNELS, 0)
    for p in profiles:
        found = _report_profile(p, *unprofiled[p.kind])
        for name in KERNELS:
            n_dev[name] += found.get(name, 0)
            n_op[name] += p.launches[name]
    per_launch = {name: n_dev[name] / n_op[name] if n_op[name] else None
                  for name in KERNELS}
    log(f"[phase 3] device kernels per launch of each op (profiled calls): "
        f"{per_launch}")
    del system, recs, factory, ppi, cpi, rec
    _free(torch)
    return launches, per_launch, step_ms


# the calls profiled in phase 3: the PPI's second 512-token prefill chunk
# (the first one meets the run's first GEMM shapes), and the CPI's 24th
# decode step (all lanes are decoding by then)
PROFILE = {"ppi": {"prefill": (512, 2)}, "cpi": {"decode": 24}}


def _report_profile(p, unprofiled_s, what, top=8, tag="[phase 3]"):
    """Print the top device operations of one profiled call, and the share
    of its wall time (host clock, between two synchronises) in which the
    device ran anything, beside the same busy time over ``unprofiled_s``,
    the median time of ``what`` unprofiled in the same run (the profiler
    slows the host; the median leaves out the first calls' warm-up).
    Returns {op name: device kernels of that op in the call}."""
    from torch.autograd import DeviceType
    spans, by_name = [], {}
    for e in p.prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        start, end = e.time_range.start, e.time_range.end
        spans.append((start, end))
        n, t = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, t + (end - start))
    if not spans:
        log(f"{tag} profile {p.label}: the profiler recorded no device "
            f"activity; device time not measured")
        return {}
    busy, cur_s, cur_e = 0.0, None, None
    for start, end in sorted(spans):
        if cur_e is None or start > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = start, end
        else:
            cur_e = max(cur_e, end)
    busy += cur_e - cur_s
    unprofiled = ("not measured" if unprofiled_s is None else
                  f"{100 * busy / (unprofiled_s * 1e6):.1f}% of the median "
                  f"unprofiled {what}, {unprofiled_s * 1e3:.3f} ms")
    log(f"{tag} profile {p.label}: wall {p.wall_s * 1e3:.3f} ms, device "
        f"busy {busy / 1e3:.3f} ms ({100 * busy / (p.wall_s * 1e6):.1f}% of "
        f"the profiled wall; {unprofiled}), {len(spans)} device ops")
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:top]
    for name, (n, t) in ranked:
        log(f"{tag}   {t / 1e3:8.3f} ms {100 * t / busy:5.1f}% of busy "
            f"x{n:<4d} {name[:110]}")
    return {op: sum(n for name, (n, _) in by_name.items()
                    if re.search(DEVICE_KERNELS[op], name))
            for op in KERNELS}


def phase_parity(torch, n_requests=N_REQUESTS, arch="llama3-8b",
                 tag="[phase 4]"):
    """Kernels vs plain versions on the main path, 2 layers at full width."""
    from repro_torch.configs import get_config
    from repro_torch.serving.api import paged_executor_factory
    cfg = dataclasses.replace(get_config(arch), n_layers=2,
                              dtype="bfloat16")
    runs = {}
    for use_kernels in (True, False):
        factory = paged_executor_factory(cfg, device="cuda",
                                         use_kernels=use_kernels)
        system, recs, res, _, _, _ = run_trace(torch, cfg, factory,
                                               n_requests, keep_logits=True)
        if res["completed"] != n_requests:
            _fail(f"parity run completed {res['completed']}/{n_requests}")
        runs[use_kernels] = {k: v for rec in recs
                             for k, v in rec.rows.items()}
        del system, recs, factory
        _free(torch)

    _compare_rows(runs[True], runs[False], f"{tag} {arch} 2-layer "
                  "full-width parity, kernels vs plain versions")


def _compare_rows(got, want, what):
    """Hold two runs' emitted logits rows to each other under
    :func:`_rows_rule`; fail if it does not hold."""
    reason = _rows_rule(got, want, what)
    if reason is not None:
        _fail(reason)


def _rows_rule(got, want, what):
    """Phase 4's rule: every compared step within ``LOGIT_TOL``; a token
    may differ only at a near-tie (both picks within ``GREEDY_TIE_MARGIN``
    plus the step's logit difference of the top), after which that
    request is compared no further (the streams diverge). Returns None if
    it holds, else why not."""
    from repro_torch.core.executor import GREEDY_TIE_MARGIN
    if set(got) != set(want):
        return f"{what}: the runs emitted different (request, token) sets"
    max_diff, agree, total, ties = 0.0, 0, 0, 0
    by_req = {}
    for key in sorted(got):
        by_req.setdefault(key[0], []).append(key)
    for keys in by_req.values():
        for key in keys:                     # in token order
            (la, ta), (lb, tb) = got[key], want[key]
            diff = float(np.abs(la - lb).max())
            max_diff = max(max_diff, diff)
            total += 1
            if ta == tb:
                agree += 1
                continue
            slack = GREEDY_TIE_MARGIN + diff
            if not all(row[t] >= row.max() - slack
                       for row in (la, lb) for t in (ta, tb)):
                return (f"{what}: token {key} differs ({ta} vs {tb}) "
                        f"without a near-tie")
            ties += 1
            break                            # the streams diverge after
    log(f"{what}: {total} compared steps, max |logit diff| {max_diff:.4f} "
        f"(tol {LOGIT_TOL}), tokens agree {agree}/{total}, near-tie "
        f"divergences {ties}")
    if not (max_diff <= LOGIT_TOL):
        return f"{what}: logits differ by {max_diff} > {LOGIT_TOL}"
    return None


# ---------------------------------------------------------------------------
# phases 5 and 6: the serving surface and the slot executor
# ---------------------------------------------------------------------------

# phase 5 serves each of these through ``ServeSpec(...).build()``
APPROACHES = ("cronus", "disagg_hl", "disagg_lh", "dp", "pp")
# the ``aggregate`` keys printed per approach (simulated clocks)
AGG_KEYS = ("ttft_p50", "ttft_p99", "tbt_p50", "tbt_p99", "throughput")
# phase 6: the slot executor's engine slots and per-slot KV capacity (the
# longest prompt plus its output, 2048 + 32, with headroom)
SLOTS, S_KV = 8, 2560
# the launcher run of phase 5
LAUNCH_ARGS = ["--arch", "llama3-8b", "--approach", "cronus", "--executor",
               "paged", "--num-kv-blocks", "2048", "--n-requests", "4",
               "--scale", "0.02", "--device", "cuda"]


def _full_model(torch, cfg):
    """``cfg``'s weights drawn once on the card from seed 0."""
    from repro_torch.models.transformer import DecoderModel
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)
    model = DecoderModel(cfg, device="cuda", generator=gen)
    torch.cuda.synchronize()
    return model, time.perf_counter() - t0


def _free(torch):
    """Return the memory of what was just deleted to the card (an engine
    and its executor, and a service and its engines, hold each other, so
    a collection is needed)."""
    gc.collect()
    torch.cuda.empty_cache()


def _serve(torch, spec, model, n_requests, profile=None):
    """Build ``spec`` on the card around ``model`` and serve the smoke's
    requests through ``InferenceService.run`` (``model=None``: the spec
    draws the weights itself); every kernel count is set to 0 just before
    the run and read just after. ``profile`` maps an
    engine's name to its Recorder's profile. Returns the service, a
    Recorder per engine, the metrics, the wall seconds (host clock
    between two synchronises), the launches and the requests."""
    from repro_torch.configs import get_config
    service = spec.build(model=model, device="cuda")
    recs = [Recorder(torch, e.name, e, profile=(profile or {}).get(e.name))
            for e in service.engines]
    cfg = get_config(spec.arch) if model is None else model.cfg
    reqs = make_requests(n_requests, cfg.vocab_size, enc_shape=(
        (cfg.enc_seq_len, cfg.d_model) if cfg.enc_dec else None))
    res, wall, launches = _counted(torch, lambda: service.run(reqs))
    return service, recs, res, wall, launches, reqs


def _report(torch, tag, recs, res, wall, n_requests):
    """Print one served run's wall, prefill tokens/s, decode steps, peak
    memory and simulated-clock aggregates; returns the Recorder of the
    engine that decoded most and its mean decode ms per step (profiled
    calls left out)."""
    prefill_s = sum(r.prefill_s for r in recs)
    prefill_tok = sum(r.prefill_tokens for r in recs)
    dec = max(recs, key=lambda r: r.decode_steps)
    step_ms = 1e3 * dec.decode_s / max(dec.decode_steps, 1)
    log(f"{tag}: completed {res['completed']}/{n_requests} in {wall:.3f} s "
        f"wall; prefill {prefill_tok} tokens in {prefill_s:.3f} s = "
        f"{prefill_tok / max(prefill_s, 1e-9):.1f} tokens/s on the card; "
        f"{dec.name} decode {dec.decode_steps} steps, mean {step_ms:.3f} "
        f"ms/step; max_memory_allocated "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    agg = ", ".join(f"{k} {res[k]:.6g}" for k in AGG_KEYS)
    log(f"{tag}: aggregate on the simulated clocks (A100/A10 device "
        f"models, not the H100): {agg}")
    if res["completed"] != n_requests:
        _fail(f"{tag}: completed {res['completed']} of {n_requests}")
    return dec, step_ms


def phase_surface(torch, n_requests=N_REQUESTS):
    """The five approaches through ``ServeSpec(executor="paged").build()``
    and ``InferenceService.run`` at full width and depth, then the
    ``repro_torch.launch.serve`` launcher in a subprocess. Returns the
    launches per kernel over the five runs."""
    from repro_torch.configs import get_config
    from repro_torch.serving.api import ServeSpec
    cfg = get_config("llama3-8b")
    model, secs = _full_model(torch, cfg)
    log(f"[phase 5] {cfg.name} {cfg.n_layers} layers {cfg.dtype}: weights "
        f"drawn on the card in {secs:.2f} s")
    total = dict.fromkeys(KERNELS, 0)
    for approach in APPROACHES:
        spec = ServeSpec(approach=approach, executor="paged", block_size=16,
                         max_slots=16, num_kv_blocks=2048)
        torch.cuda.reset_peak_memory_stats()
        service, recs, res, wall, launches, _ = _serve(torch, spec, model,
                                                    n_requests)
        tag = f"[phase 5] {approach}"
        _report(torch, tag, recs, res, wall, n_requests)
        log(f"{tag}: launches {launches}; per engine (prefill chunks, "
            f"decode steps, decode lanes): "
            + ", ".join(f"{r.name} ({r.calls['prefill']}, "
                        f"{r.calls['decode']}, {r.calls['lanes']})"
                        for r in recs))
        if min(launches.values()) == 0:
            _fail(f"{tag}: a kernel of the path never launched: {launches}")
        for name in KERNELS:
            total[name] += launches[name]
        del service, recs
        _free(torch)
    del model
    _free(torch)

    _launcher(LAUNCH_ARGS, "[phase 5]")
    return total


def _launcher(args, tag, n=4):
    """``python -m repro_torch.launch.serve args`` in a subprocess on the
    card; it must exit 0 with ``n`` requests completed."""
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", *args]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    run = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=600)
    secs = time.perf_counter() - t0
    if run.returncode != 0:
        _fail(f"{tag} launch.serve exited {run.returncode}: "
              f"{run.stderr[-2000:]}")
    metrics = json.loads(run.stdout)
    log(f"{tag} python -m repro_torch.launch.serve {' '.join(args)}: exit 0 "
        f"in {secs:.1f} s, completed {metrics['completed']}, "
        f"simulated-clock "
        + ", ".join(f"{k} {metrics[k]:.6g}" for k in AGG_KEYS))
    if metrics["completed"] != n:
        _fail(f"{tag} launch.serve completed {metrics['completed']} of {n}")


def phase_slot(torch, paged_step_ms, n_requests=N_REQUESTS):
    """The slot executor: Cronus through ``ServeSpec(executor="real")``
    at full width and depth, then slot against paged at 2 layers on the
    same weights and trace."""
    from repro_torch.configs import get_config
    from repro_torch.serving import hardware
    from repro_torch.serving.api import (ServeSpec, paged_executor_factory,
                                         slot_executor_factory)
    from repro_torch.serving.simulator import build_system
    cfg = get_config("llama3-8b")
    model, _ = _full_model(torch, cfg)
    spec = ServeSpec(approach="cronus", executor="real", max_slots=SLOTS,
                     s_kv=S_KV)
    torch.cuda.reset_peak_memory_stats()
    # the same CPI decode step as phase 3 runs under the profiler
    service, recs, res, wall, launches, _ = _serve(
        torch, spec, model, n_requests, profile={"cpi": PROFILE["cpi"]})
    cpi, step_ms = _report(torch, f"[phase 6] cronus slot executor "
                           f"(max_slots {SLOTS}, s_kv {S_KV})", recs, res,
                           wall, n_requests)
    paged = ("not run" if paged_step_ms is None
             else f"{paged_step_ms:.3f} ms")
    log(f"[phase 6] CPI decode step: slot {step_ms:.3f} ms, paged (phase 3, "
        f"16 slots, same requests) {paged}; kernel launches in the slot "
        f"run {launches}")
    for p in cpi.profiles:
        _report_profile(p, statistics.median(cpi.step_s), "CPI decode step",
                        tag="[phase 6]")
    del service, recs, cpi, model
    _free(torch)

    cfg2 = dataclasses.replace(cfg, n_layers=2)
    model2, _ = _full_model(torch, cfg2)
    runs = {}
    for kind in ("real", "paged"):
        if kind == "real":
            factory = slot_executor_factory(cfg2, model2, device="cuda",
                                            max_slots=SLOTS, s_kv=S_KV)
        else:
            factory = paged_executor_factory(cfg2, model2, device="cuda")
        # the same KV budget for both, so both admit the same batches
        system = build_system("cronus", cfg2, hardware.A100, hardware.A10,
                              executor_factory=factory, executor=kind,
                              block_size=16, max_batched_tokens=512,
                              max_slots=SLOTS,
                              num_kv_blocks=SLOTS * -(-S_KV // 16))
        recs = [Recorder(torch, role, e, keep_logits=True)
                for role, e in (("ppi", system.ppi), ("cpi", system.cpi))]
        res = system.run(make_requests(n_requests, cfg2.vocab_size))
        if res["completed"] != n_requests:
            _fail(f"phase 6 {kind} run completed {res['completed']}/"
                  f"{n_requests}")
        runs[kind] = {k: v for rec in recs for k, v in rec.rows.items()}
        del system, recs, factory
        _free(torch)
    _compare_rows(runs["real"], runs["paged"], "[phase 6] 2-layer "
                  "full-width slot executor vs paged executor")


# ---------------------------------------------------------------------------
# phase 7: the dense families
# ---------------------------------------------------------------------------

# (run, arch, layers kept or None for full depth, executor); widths are
# never cut
FAMILY_RUNS = (
    ("7b", "qwen3-32b", 8, "paged"),      # qk-norm on the paged path
    ("7c", "gemma3-27b", 6, "real"),      # 5 local (window 1024) : 1 global
    ("7d", "qwen2-vl-72b", 4, "real"),    # M-RoPE (16, 24, 24), text only
)
# the launcher run of phase 7a
LAUNCH_ARGS_7A = ["--arch", "qwen2-7b", "--approach", "cronus", "--executor",
                  "paged", "--num-kv-blocks", "2048", "--n-requests", "4",
                  "--scale", "0.02", "--device", "cuda"]


def _describe(cfg, full):
    """One line of a config's shape and its depth cut, if any."""
    cut = ("full depth" if cfg.n_layers == full.n_layers else
           f"depth cut {full.n_layers} -> {cfg.n_layers} layers (widths "
           f"kept)")
    extra = []
    if cfg.qk_norm:
        extra.append("qk-norm")
    if cfg.window_size:
        extra.append("windows " + str([cfg.layer_window(i)
                                       for i in range(cfg.n_layers)]))
    if cfg.mrope_sections:
        extra.append(f"M-RoPE {cfg.mrope_sections}")
    from repro_torch.models.api import param_shapes

    def count(tree):
        return sum(count(v) if isinstance(v, dict) else math.prod(v)
                   for v in tree.values())
    n_params = count(param_shapes(cfg))      # what lies on the card
    return (f"{cfg.name}: {cfg.n_layers} layers ({cut}) d_model "
            f"{cfg.d_model} heads {cfg.n_heads}/{cfg.n_kv_heads} (G "
            f"{cfg.n_heads // cfg.n_kv_heads}) head_dim {cfg.head_dim} d_ff "
            f"{cfg.d_ff} vocab {cfg.vocab_size} {cfg.dtype}"
            + (", " + ", ".join(extra) if extra else "")
            + f"; {n_params / 1e9:.2f} B parameters")


def _family_report(torch, tag, recs, res, wall, launches, reqs, executor,
                   n_requests):
    """Phase 7's lines of one served run; fails unless every request
    completed and, on the paged path, both kernels launched on the split
    Cronus pair."""
    _report(torch, tag, recs, res, wall, n_requests)
    splits = [(r.input_len, r.partial_len) for r in reqs]
    log(f"{tag}: launches {launches}; (input_len, partial_len): {splits}")
    if executor != "paged":
        return
    if min(launches.values()) == 0:
        _fail(f"{tag}: a kernel of the path never launched: {launches}")
    if not any(0 < p < n for n, p in splits):
        _fail(f"{tag}: no request was split between PPI and CPI")


def phase_families(torch, n_requests=N_REQUESTS):
    """The dense families at full width. 7a: qwen2-7b at full depth
    through ``ServeSpec(arch="qwen2-7b", executor="paged").build()``, a
    2-layer kernels-vs-plain parity run and the launcher; 7b-7d: the
    qk-norm, sliding-window and M-RoPE families at a cut depth on the
    executor the JAX package serves them on, each paged one followed by
    its 2-layer parity run. Returns the launches per kernel over the
    paged runs."""
    from repro_torch.configs import get_config
    from repro_torch.core.executor import PagedRealExecutor
    from repro_torch.serving.api import (ServeSpec, paged_executor_factory,
                                         slot_executor_factory)
    total = dict.fromkeys(KERNELS, 0)

    cfg = get_config("qwen2-7b")
    log(f"[phase 7a] {_describe(cfg, cfg)}")
    spec = ServeSpec(arch="qwen2-7b", approach="cronus", executor="paged",
                     block_size=16, max_slots=16, num_kv_blocks=2048)
    torch.cuda.reset_peak_memory_stats()
    service, recs, res, wall, launches, reqs = _serve(torch, spec, None,
                                                      n_requests)
    _family_report(torch, "[phase 7a] cronus paged (ServeSpec.build)", recs,
                   res, wall, launches, reqs, "paged", n_requests)
    for name in KERNELS:
        total[name] += launches[name]
    del service, recs, reqs
    _free(torch)
    phase_parity(torch, n_requests, arch="qwen2-7b", tag="[phase 7a]")
    _launcher(LAUNCH_ARGS_7A, "[phase 7a]")

    for run, arch, layers, executor in FAMILY_RUNS:
        tag = f"[phase {run}]"
        full = get_config(arch)
        cfg = dataclasses.replace(full, n_layers=layers or full.n_layers)
        model, secs = _full_model(torch, cfg)
        log(f"{tag} {_describe(cfg, full)}; weights drawn on the card in "
            f"{secs:.2f} s")
        if executor == "paged":
            factory = paged_executor_factory(cfg, model, device="cuda")
        else:
            try:
                PagedRealExecutor(model)
            except NotImplementedError as e:
                log(f"{tag} PagedRealExecutor refuses it, as the JAX "
                    f"package's does: {e}")
            else:
                _fail(f"{tag} PagedRealExecutor accepted {cfg.name}")
            factory = slot_executor_factory(cfg, model, device="cuda",
                                            max_slots=SLOTS, s_kv=S_KV)
        torch.cuda.reset_peak_memory_stats()
        system, recs, res, wall, launches, reqs = run_trace(
            torch, cfg, factory, n_requests, executor=executor)
        what = ("paged" if executor == "paged"
                else f"slot executor ({SLOTS} slots x {S_KV} positions)")
        _family_report(torch, f"{tag} cronus {what}", recs, res, wall,
                       launches, reqs, executor, n_requests)
        del system, recs, factory, model
        _free(torch)
        if executor == "paged":
            for name in KERNELS:
                total[name] += launches[name]
            # the kernels against their plain versions at this family's
            # heads, 2 layers at full width
            phase_parity(torch, n_requests, arch=arch, tag=tag)
    return total


# ---------------------------------------------------------------------------
# phase 8: the MoE families on the slot executor
# ---------------------------------------------------------------------------

# (run, arch, layers kept): the dense first layer and MoE layers after it;
# widths, expert count, top-k and shared experts are kept. One routed
# layer of kimi-k2 is 16.9 B parameters, so a third layer would not fit
# beside the working memory.
MOE_RUNS = (
    ("8a", "deepseek-v2-236b", 5),    # MoE + MLA: 1 dense + 4 MoE layers
    ("8b", "kimi-k2-1t-a32b", 2),     # MoE + GQA: 1 dense + 1 MoE layer
)
# the engines' KV budget: SLOTS x S_KV positions, phase 7's 8 x 160
# blocks of 16. ``ServeSpec`` refuses ``num_kv_blocks`` with
# executor="real" (as the JAX package's does: it sizes the paged pool), and
# the simulated A100/A10 budgets for these weights, which outgrow both
# cards, are ``build_cronus``'s 64-block floor; so the block is made 320
# tokens, and 64 of them hold the same 20480 positions
MOE_BLOCK = SLOTS * S_KV // 64
# tokens of phase 8c's check of the MoE block against its dense oracle
MOE_CHECK_TOKENS = 64
# the launcher run of phase 8d
LAUNCH_ARGS_8D = ["--arch", "deepseek-v2-236b", "--smoke", "--executor",
                  "real", "--n-requests", "4", "--scale", "0.02",
                  "--device", "cuda"]


def _moe_text(cfg):
    """The MoE and MLA widths of a config, for phase 8's lines."""
    text = (f"{cfg.moe_dense_layers} dense layer(s) of d_ff "
            f"{cfg.moe_dense_d_ff}, then {cfg.n_experts} routed experts "
            f"top-{cfg.top_k} + {cfg.n_shared_experts} shared of d_ff "
            f"{cfg.d_ff}")
    if cfg.mla_kv_lora_rank:
        text += (f"; MLA kv rank {cfg.mla_kv_lora_rank}, q rank "
                 f"{cfg.mla_q_lora_rank}, nope/rope/v head dims "
                 f"{cfg.mla_nope_head_dim}/{cfg.mla_rope_head_dim}/"
                 f"{cfg.mla_v_head_dim}")
    return text


def _moe_oracle(torch, tag, model):
    """(8c) The first MoE layer of ``model`` at full width in bf16 on
    MOE_CHECK_TOKENS tokens: ``moe_block(exact=True)`` against the dense
    oracle, and capacity mode's dropped pairs at the config's factor.

    Tolerance, elementwise: |got - want| <= 2^-6 * (S + P) + 2^-12, with
    S = sum over the token's top-k of w_k * |y_k| (y_k: expert k's output)
    and P the largest magnitude of the output's partial sums (the routed
    sum, then each shared expert added), both from the oracle's own
    values in fp32. The two route through the same router product on the
    same inputs, so they pick the same experts and weights; both take the
    products w_k * y_k exactly in fp32 and sum them in fp32. What differs
    is the order of fp32 sums: each y_k comes from a product over that
    expert's rows in one and over all rows in the other, so its bf16
    rounding may land one ulp (<= 2^-7 * |y_k|) apart, which weighs
    <= 2^-7 * S in the sum; and each rounding of a partial sum to bf16 may
    land one ulp (<= 2^-7 * P) apart. Two ulps at each level give the
    rule; 2^-12 covers entries near 0. Dropping expert k's contribution
    moves the token's row by w_k * y_k: each token's lowest-weighted
    expert is dropped from the oracle in turn, and the median over the
    tokens of the rule's max err/tol must reach 10 (the smallest, and
    token 0's, are printed)."""
    from repro_torch.models import moe
    from repro_torch.models.layers import swiglu
    from repro_torch.models.transformer import layer_slice
    cfg = model.cfg
    p = layer_slice(model.params["layers"]["moe"], 0)
    gen = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn((1, MOE_CHECK_TOKENS, cfg.d_model), generator=gen,
                    device="cuda").to(model.dtype)
    t0 = time.perf_counter()
    got, aux = moe.moe_block(p, cfg, x, exact=True)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    want = moe.moe_block_dense_ref(p, cfg, x)[0].float()
    got = got[0].float()
    y, w = moe.dense_expert_outputs(p, cfg, x[0])
    yf = y.float()
    part = torch.einsum("etd,te->td", yf, w)
    big = part.abs()
    for i in range(cfg.n_shared_experts):
        sp = p[f"shared_{i}"]
        part = part + swiglu(x[0], sp["w_gate"], sp["w_up"],
                             sp["w_down"]).float()
        big = torch.maximum(big, part.abs())
    tol = 2.0 ** -6 * (torch.einsum("etd,te->td", yf.abs(), w) + big) \
        + 2.0 ** -12
    ratio = ((got - want).abs() / tol).max().item()
    rows = torch.arange(MOE_CHECK_TOKENS, device=w.device)
    weak = torch.where(w > 0, w, float("inf")).argmin(-1)       # [T]
    cut = want - w[rows, weak][:, None] * yf[weak, rows]
    cut_ratio = ((got - cut).abs() / tol).amax(-1)              # [T]
    med = cut_ratio.median().item()
    _, _, idx = moe.route(p, cfg, x[0])
    cap = moe.capacity(MOE_CHECK_TOKENS, cfg, False)
    _, _, dropped = moe.dispatch(idx, cfg.n_experts, cap)
    log(f"{tag} moe_block(exact) vs dense oracle, layer {model.n_dense} "
        f"of {cfg.name} ({cfg.n_experts} experts top-{cfg.top_k}), "
        f"{MOE_CHECK_TOKENS} tokens bf16: max abs err "
        f"{(got - want).abs().max().item():.4g}, max err/tol {ratio:.4f} "
        f"(tol 2^-6*(S + P) + 2^-12, passes at <= 1); each token's "
        f"lowest-weighted expert dropped from the oracle: err/tol median "
        f"{med:.2f} (must be >= 10), min {cut_ratio.min().item():.2f}, "
        f"token 0 {cut_ratio[0].item():.2f} (expert {weak[0].item()}, w "
        f"{w[0, weak[0]].item():.4f}); aux {aux.item():.6f}; block "
        f"{1e3 * secs:.3f} ms (host clock, first call); capacity mode at "
        f"factor {cfg.capacity_factor}: capacity {cap}, {int(dropped)} of "
        f"{MOE_CHECK_TOKENS * cfg.top_k} pairs dropped")
    if not ratio <= 1.0:
        _fail(f"{tag} moe_block vs dense oracle: err/tol {ratio:.4f}")
    if not med >= 10.0:
        _fail(f"{tag} the oracle rule misses a dropped expert: median "
              f"err/tol {med:.2f} < 10")


def phase_moe(torch, n_requests=N_REQUESTS):
    """The MoE families at full width on the slot executor, each drawn on
    the card from seed 0 in bf16 at a cut depth and served by Cronus
    through ``ServeSpec(arch=..., executor="real").build()``: (8a)
    deepseek-v2-236b (MoE + MLA), (8b) kimi-k2-1t-a32b (MoE + GQA), each
    followed by (8c) its first MoE layer against the dense oracle; then
    (8d) the launcher on deepseek-v2's smoke config. No kernel of the repo
    runs here (the paged executor refuses these models)."""
    from repro_torch.configs import get_config
    from repro_torch.core.executor import PagedRealExecutor
    from repro_torch.models.transformer import DecoderModel
    from repro_torch.serving.api import ServeSpec
    for run, arch, layers in MOE_RUNS:
        tag = f"[phase {run}]"
        full = get_config(arch)
        cfg = dataclasses.replace(full, n_layers=layers)
        t0 = time.perf_counter()
        gen = torch.Generator(device="cuda").manual_seed(0)
        model = DecoderModel(cfg, device="cuda", generator=gen,
                             exact_moe=True)
        torch.cuda.synchronize()
        log(f"{tag} {_describe(cfg, full)}; {_moe_text(cfg)}; weights "
            f"drawn on the card in {time.perf_counter() - t0:.2f} s, "
            f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
        try:
            PagedRealExecutor(model)
        except NotImplementedError as e:
            log(f"{tag} PagedRealExecutor refuses it, as the JAX "
                f"package's does: {e}")
        else:
            _fail(f"{tag} PagedRealExecutor accepted {cfg.name}")
        spec = ServeSpec(arch=arch, approach="cronus", executor="real",
                         max_slots=SLOTS, s_kv=S_KV, block_size=MOE_BLOCK)
        torch.cuda.reset_peak_memory_stats()
        service, recs, res, wall, launches, reqs = _serve(torch, spec,
                                                          model, n_requests)
        _family_report(torch, f"{tag} cronus slot executor ({SLOTS} slots "
                       f"x {S_KV} positions, ServeSpec.build)", recs, res,
                       wall, launches, reqs, "real", n_requests)
        if any(launches.values()):
            _fail(f"{tag} a kernel of the repo launched: {launches}")
        # the PPI->CPI handoff (the dense first layer's cache included)
        if not any(0 < r.partial_len < r.input_len for r in reqs):
            _fail(f"{tag} no request was split between PPI and CPI")
        del service, recs, reqs
        _free(torch)
        _moe_oracle(torch, f"[phase 8c] {arch}", model)
        del model
        _free(torch)
    _launcher(LAUNCH_ARGS_8D, "[phase 8d]")


# ---------------------------------------------------------------------------
# phase 9: SSM, hybrid and encoder-decoder on the slot executor
# ---------------------------------------------------------------------------

# (run, arch, what its PPI->CPI payload carries), each at full width and
# full depth
SSM_RUNS = (
    ("9a", "mamba2-780m", "SSM state h/conv"),
    ("9b", "hymba-1.5b", "attention k/v + SSM state h/conv"),
    ("9c", "whisper-base", "cross-KV + self-attention k/v"),
)
# 9d: decode steps after the payload check's prefill
PAYLOAD_STEPS = 4
# 9e: the SSD scan against its oracle, (name, H, P, N) at chunk 64 on
# B x T tokens, fp32; the rule of tests/test_ssm.py:
# |got - want| <= SSD_TOL + SSD_TOL * |want|
SSD_SHAPES = (("mamba2-780m", 48, 64, 128), ("hymba-1.5b", 50, 64, 16))
SSD_B, SSD_T, SSD_CHUNK, SSD_TOL = 2, 512, 64, 1e-4
# the launcher run of phase 9f
LAUNCH_ARGS_9F = ["--arch", "hymba-1.5b", "--smoke", "--executor", "real",
                  "--n-requests", "4", "--scale", "0.02", "--device", "cuda"]


def _state_text(cfg):
    """The recurrent / cross-attention state of a config, for phase 9."""
    from repro_torch.models.ssm import ssm_dims
    if cfg.enc_dec:
        per_slot = (2 * cfg.n_layers * cfg.enc_seq_len * cfg.n_kv_heads
                    * cfg.head_dim * 2)
        return (f"{cfg.n_enc_layers} encoder + {cfg.n_layers} decoder "
                f"layers, {cfg.enc_seq_len} encoder frames; cross-KV "
                f"{per_slot / 1e6:.1f} MB a slot")
    _, h, p, n, conv_dim = ssm_dims(cfg)
    per_slot = cfg.n_layers * (h * p * n * 4 + (cfg.ssm_conv_width - 1)
                               * conv_dim * 2)
    return (f"SSM heads {h} x P {p} x N {n}, conv {conv_dim} wide, chunk "
            f"{cfg.ssm_chunk}; h + conv {per_slot / 1e6:.1f} MB a slot")


def _payload_check(torch, tag, model, req, what):
    """(9d) One executor prefills the first part of ``req``'s prompt;
    ``extract_kv`` -> ``inject_kv`` moves it to another slot of a fresh
    executor, which finishes the prefill and decodes PAYLOAD_STEPS
    tokens. A third executor runs the same two chunks and steps in one
    slot. The two runs' logits must meet phase 4's rule; for an
    encoder-decoder, the payload with its cross-KV zeroed must not."""
    from repro_torch.core.executor import RealExecutor
    prompt, enc = req.prompt, req.enc_emb
    split = len(prompt) * 2 // 5

    def serve(ex, slot, token):
        rows = {("p", 0): (ex.last_logits[0].copy(), token)}
        for t in range(PAYLOAD_STEPS):
            token = ex.decode({slot: token}, {slot: len(prompt) + t})[slot]
            rows[("p", t + 1)] = (ex.last_logits[0].copy(), token)
        return rows

    one = RealExecutor(model, max_slots=1, s_kv=S_KV)
    one.prefill_chunk(0, prompt[:split], 0, False, enc_emb=enc)
    want = serve(one, 0, one.prefill_chunk(0, prompt[split:], split, True))
    del one
    ppi = RealExecutor(model, max_slots=2, s_kv=S_KV)
    ppi.prefill_chunk(1, prompt[:split], 0, False, enc_emb=enc)
    payload = ppi.extract_kv(1, split)
    del ppi

    def size(tree):
        return sum(size(v) if isinstance(v, dict) else
                   v.numel() * v.element_size()
                   for k, v in tree.items() if k != "_upto")
    nbytes = size(payload)
    cases = [("payload", payload)]
    if "cross_k" in payload:
        cases.append(("cross-KV zeroed", dict(
            payload, cross_k=torch.zeros_like(payload["cross_k"]),
            cross_v=torch.zeros_like(payload["cross_v"]))))
    for name, pl in cases:
        cpi = RealExecutor(model, max_slots=3, s_kv=S_KV)
        cpi.inject_kv(2, pl, split)
        got = serve(cpi, 2, cpi.prefill_chunk(2, prompt[split:], split,
                                              True))
        del cpi
        reason = _rows_rule(got, want, f"{tag} {name} ({what}, "
                            f"{nbytes / 1e6:.1f} MB for {split} of "
                            f"{len(prompt)} tokens) vs one executor")
        if name == "payload" and reason is not None:
            _fail(reason)
        if name != "payload":
            if reason is None:
                _fail(f"{tag} the check passed with the cross-KV zeroed")
            log(f"{tag} with the cross-KV zeroed the rule fails, as it "
                f"must: {reason}")
    _free(torch)


def _ssd_check(torch):
    """(9e) ``ssd_chunked`` against the token-recurrent ``ssd_ref`` on the
    card at mamba2's and hymba's head widths, fp32 with TF32 off, from a
    nonzero initial state."""
    import torch.nn.functional as F
    from repro_torch.models.ssm import ssd_chunked, ssd_ref
    for name, h, p, n in SSD_SHAPES:
        gen = torch.Generator(device="cuda").manual_seed(3)

        def draw(*shape):
            return torch.randn(shape, generator=gen, device="cuda")
        x, dt = draw(SSD_B, SSD_T, h, p), F.softplus(draw(SSD_B, SSD_T, h))
        a_neg = -torch.exp(draw(h) * 0.3)
        b_in, c_in = draw(SSD_B, SSD_T, n), draw(SSD_B, SSD_T, n)
        h0 = draw(SSD_B, h, p, n) * 0.1
        args = (x, dt * 0.1, a_neg, b_in, c_in, h0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        y, hf = ssd_chunked(*args, SSD_CHUNK)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        yr, hr = ssd_ref(*args)
        worst = []
        for got, want in ((y, yr), (hf, hr)):
            err = (got - want).abs()
            worst.append((err.max().item(), (err / (SSD_TOL + SSD_TOL
                                                     * want.abs())).max()
                          .item()))
        log(f"[phase 9e] ssd_chunked vs ssd_ref at {name}'s widths (H {h}, "
            f"P {p}, N {n}, chunk {SSD_CHUNK}), B {SSD_B} x {SSD_T} tokens "
            f"fp32, h0 != 0: y max abs err {worst[0][0]:.3e}, h_final "
            f"{worst[1][0]:.3e}; max err/tol {max(r for _, r in worst):.4f} "
            f"(tol {SSD_TOL:g} + {SSD_TOL:g}*|want|, passes at <= 1); "
            f"ssd_chunked {1e3 * secs:.3f} ms (host clock, first call)")
        if not max(r for _, r in worst) <= 1.0:
            _fail(f"[phase 9e] ssd_chunked vs ssd_ref at {name}'s widths")


def phase_ssm(torch, n_requests=N_REQUESTS):
    """The SSM, hybrid and encoder-decoder families at full width and full
    depth on the slot executor, drawn on the card from seed 0 in bf16 and
    served by Cronus through ``ServeSpec(arch=..., executor="real")
    .build()``, one after another: (9a) mamba2-780m, (9b) hymba-1.5b,
    (9c) whisper-base, each followed by (9d) its PPI->CPI payload check;
    then (9e) the SSD scan against its oracle and (9f) the launcher on
    hymba's smoke config. No kernel of the repo runs here (the paged
    executor refuses these models)."""
    from repro_torch.configs import get_config
    from repro_torch.core.executor import PagedRealExecutor
    from repro_torch.serving.api import ServeSpec
    for run, arch, what in SSM_RUNS:
        tag = f"[phase {run}]"
        cfg = get_config(arch)
        log(f"{tag} {_describe(cfg, cfg)}; {_state_text(cfg)}")
        spec = ServeSpec(arch=arch, approach="cronus", executor="real",
                         max_slots=SLOTS, s_kv=S_KV, block_size=MOE_BLOCK)
        torch.cuda.reset_peak_memory_stats()
        # phase 3's calls run under the profiler (and out of the timings)
        service, recs, res, wall, launches, reqs = _serve(
            torch, spec, None, n_requests, profile=PROFILE)
        _family_report(torch, f"{tag} cronus slot executor ({SLOTS} slots "
                       f"x {S_KV} positions, ServeSpec.build)", recs, res,
                       wall, launches, reqs, "real", n_requests)
        if any(launches.values()):
            _fail(f"{tag} a kernel of the repo launched: {launches}")
        if not any(0 < r.partial_len < r.input_len for r in reqs):
            _fail(f"{tag} no request was split between PPI and CPI")
        chunk = PROFILE["ppi"]["prefill"][0]
        chunks = [t for r in recs for t in r.chunk_s.get(chunk, [])]
        steps = [t for r in recs if r.name == "cpi" for t in r.step_s]
        unprofiled = {"prefill": (statistics.median(chunks) if chunks
                                  else None, f"{chunk}-token chunk"),
                      "decode": (statistics.median(steps) if steps else None,
                                 "CPI decode step")}
        for p in (p for r in recs for p in r.profiles):
            _report_profile(p, *unprofiled[p.kind], tag=tag)
        model = service.engines[0].executor.model
        try:
            PagedRealExecutor(model)
        except NotImplementedError as e:
            log(f"{tag} PagedRealExecutor refuses it, as the JAX "
                f"package's does: {e}")
        else:
            _fail(f"{tag} PagedRealExecutor accepted {cfg.name}")
        del service, recs
        _free(torch)
        _payload_check(torch, f"[phase 9d] {arch}", model, reqs[0], what)
        del model, reqs
        _free(torch)
    _ssd_check(torch)
    _launcher(LAUNCH_ARGS_9F, "[phase 9f]")


# ---------------------------------------------------------------------------
# phase 10: training
# ---------------------------------------------------------------------------

# (10a) llama3-8b at full width cut to 4 of 32 layers: at full depth its
# fp32 master weights, gradients and AdamW moments would be 8.0 B params
# x 16 B = 128 GB; at 4 layers, 1.92 B params and ~31 GB. bf16 compute on
# fp32 masters, batch 4 x 1024 tokens. A peak rate of 3e-4 after 2 warmup
# steps diverges at this width (losses 16.7 and 18.2 at steps 3 and 5,
# grad norms ~70, in this script's first run on the card); 1e-4 does not
TRAIN_LAYERS, TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, 4, 1024, 8
TRAIN_OPT = dict(lr=1e-4, warmup_steps=2, total_steps=100)
# (10b) the directional derivative of the loss at full width, 2 layers,
# fp32 with TF32 off, one batch of 1 x 64 tokens, along a unit direction
# d over every leaf drawn from seed 0: (L(p + eps d) - L(p - eps d)) /
# 2 eps against <grad L, d>. A unit d over 1.5 B params moves each by
# ~2.6e-5, so <grad L, d> ~ |grad L| / 3.9e4; eps = 10 moves the weights
# by ~1.5% of their norm (the central difference's error is second order
# in that), and lifts the difference of the two losses ~1e3 over their
# fp32 rounding (~1e-6 at a loss of ~12). Dropping the leaf whose term of
# <grad L, d> is largest changes it by >= 1/leaves, far past the tolerance
GRAD_LAYERS, GRAD_SEQ, GRAD_EPS, GRAD_RTOL = 2, 64, 10.0, 1e-2
# (10c) the SSM and encoder-decoder families at full width and depth, at
# a peak rate of 3e-4 for their narrower widths (d 1536, 512; at 1e-3
# mamba2-780m's loss jumped at step 4 in the first run on the card)
TRAIN_FAMILIES = ("mamba2-780m", "whisper-base")
FAMILY_STEPS = 6
FAMILY_OPT = dict(TRAIN_OPT, lr=3e-4)
# (10d) checkpoint round trip: whisper-base saved after step 2 of 2 x 256
CKPT_ARCH, CKPT_STEP, CKPT_BATCH, CKPT_SEQ = "whisper-base", 2, 2, 256
LAUNCH_ARGS_10E = ["--steps", "20"]


def _train_run(torch, tag, cfg, full, n_steps, opt_kw):
    """Train ``cfg`` through ``Trainer`` on the card: the model drawn from
    seed 0 in bf16, ``Trainer.init(0)``'s fp32 masters and AdamW state,
    the batches made on the host before the timed steps; each step timed
    on the host clock between synchronises, with the kernel counts set to
    0 before the steps and read after; then one more step under
    ``torch.profiler`` (not timed). Fails unless every loss and
    grad norm is finite, the last loss is below the first and neither
    kernel launched."""
    from repro_torch.models.api import build_model
    from repro_torch.training import AdamWConfig, Trainer
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = build_model(cfg, device="cuda", generator=torch.Generator(
        device="cuda").manual_seed(0))
    trainer = Trainer(model, AdamWConfig(**opt_kw),
                      batch_size=TRAIN_BATCH, seq_len=TRAIN_SEQ)
    params, opt = trainer.init(0)
    torch.cuda.synchronize()
    log(f"{tag} {_describe(cfg, full)}; model and fp32 masters + AdamW "
        f"state drawn on the card in {time.perf_counter() - t0:.2f} s "
        f"({torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated)")
    t0 = time.perf_counter()
    batches = [trainer.batch(s) for s in range(n_steps + 1)]
    torch.cuda.synchronize()
    data_s = time.perf_counter() - t0
    log(f"{tag} data: {len(batches)} batches of {TRAIN_BATCH} x "
        f"{TRAIN_SEQ} tokens made in {data_s:.3f} s on the host "
        f"({data_s / len(batches):.3f} s a batch), before the timed steps")
    losses, gnorms, step_s = [], [], []

    def steps():
        nonlocal params, opt
        for b in batches[:n_steps]:
            t = time.perf_counter()
            params, opt, stats = trainer.step(params, opt, b)
            losses.append(float(stats["loss"]))
            gnorms.append(float(stats["grad_norm"]))
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t)
    _, wall, launches = _counted(torch, steps)
    med = statistics.median(step_s)
    log(f"{tag} losses {[round(x, 4) for x in losses]}; grad norms "
        f"{[round(x, 4) for x in gnorms]}")
    log(f"{tag} {n_steps} steps in {wall:.3f} s: step ms "
        f"{[round(1e3 * s, 3) for s in step_s]}, median {1e3 * med:.3f} ms "
        f"= {TRAIN_BATCH * TRAIN_SEQ / med:.1f} tokens/s; "
        f"max_memory_allocated "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches "
        f"{launches}")
    _, prof, pwall = Recorder._profiled(
        torch, lambda: trainer.step(params, opt, batches[-1]))
    _report_profile(Profile(f"training step {n_steps + 1}", "train", prof,
                            pwall, {}), med, "training step", tag=tag)
    if not all(map(math.isfinite, losses + gnorms)):
        _fail(f"{tag} a loss or grad norm is not finite")
    if not losses[-1] < losses[0]:
        _fail(f"{tag} the loss did not fall: {losses}")
    if any(launches.values()):
        _fail(f"{tag} a kernel of the repo launched: {launches}")


def _grad_check(torch):
    """(10b) The directional derivative along a random unit direction
    against the gradient's projection on it, at full width in fp32."""
    from repro_torch.configs import get_config
    from repro_torch.models.api import build_model
    from repro_torch.training import Trainer
    from repro_torch.training.tree import flatten, unflatten
    tag = "[phase 10b]"
    full = get_config("llama3-8b")
    cfg = dataclasses.replace(full, n_layers=GRAD_LAYERS, dtype="float32")
    model = build_model(cfg, device="cuda", generator=torch.Generator(
        device="cuda").manual_seed(0))
    batch = Trainer(model, batch_size=1, seq_len=GRAD_SEQ).batch(0)
    leaves = {k: v.detach().requires_grad_()
              for k, v in flatten(model.params).items()}
    loss = model.loss(unflatten(leaves), batch)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    gen = torch.Generator(device="cuda").manual_seed(0)
    d = {k: torch.randn(v.shape, generator=gen, device="cuda")
         for k, v in leaves.items()}
    norm = math.sqrt(sum(float((x.double() ** 2).sum()) for x in d.values()))
    terms = {k: float((g.double() * d[k].double()).sum()) / norm
             for k, g in zip(leaves, grads)}
    dot = sum(terms.values())
    with torch.no_grad():
        lp, lm = (float(model.loss(unflatten(
            {k: v + (sign * GRAD_EPS / norm) * d[k]
             for k, v in leaves.items()}), batch)) for sign in (1, -1))
    fd = (lp - lm) / (2 * GRAD_EPS)
    rel = abs(fd - dot) / abs(dot)
    big = max(terms, key=lambda k: abs(terms[k]))
    missing = abs(fd - (dot - terms[big])) / abs(dot - terms[big])
    log(f"{tag} {_describe(cfg, full)}; batch 1 x {GRAD_SEQ}, TF32 off: "
        f"loss {loss.item():.6f}; eps {GRAD_EPS:g}: L(p+eps d) {lp:.7f}, "
        f"L(p-eps d) {lm:.7f}; central difference {fd:.6e}, <grad L, d> "
        f"{dot:.6e}, ratio {fd / dot:.6f}, rel err {rel:.3e} (tol "
        f"{GRAD_RTOL:g}); without the gradient of {big} (the largest of "
        f"{len(terms)} terms) the rel err would read {missing:.3e}")
    if not rel <= GRAD_RTOL:
        _fail(f"{tag} the directional derivative misses <grad L, d>")
    if not missing > GRAD_RTOL:
        _fail(f"{tag} the check cannot tell a missing leaf")


def _ckpt_round_trip(torch):
    """(10d) Save after step ``CKPT_STEP``, load into a fresh trainer whose
    own weights are drawn from another seed, take the next step: its loss,
    parameters and AdamW state must equal those of the run that never
    stopped, bit for bit."""
    from repro_torch.configs import get_config
    from repro_torch.models.api import build_model
    from repro_torch.training import (AdamWConfig, Trainer,
                                      load_checkpoint, save_checkpoint)
    from repro_torch.training.tree import flatten
    tag = "[phase 10d]"
    cfg = get_config(CKPT_ARCH)

    def trainer():
        model = build_model(cfg, device="cuda", generator=torch.Generator(
            device="cuda").manual_seed(0))
        return Trainer(model, AdamWConfig(**TRAIN_OPT),
                       batch_size=CKPT_BATCH, seq_len=CKPT_SEQ)
    path = ROOT / "build" / "phase10d" / "ckpt.npz"
    a = trainer()
    p, o, _ = a.run(*a.init(0), CKPT_STEP, log=None)
    t0 = time.perf_counter()
    save_checkpoint(str(path), p, o, CKPT_STEP)
    save_s = time.perf_counter() - t0
    p, o, want = a.run(p, o, 1, log=None, start=CKPT_STEP)
    b = trainer()
    t0 = time.perf_counter()
    tp, to, step = load_checkpoint(str(path), *b.init(1))
    load_s = time.perf_counter() - t0
    tp, to, got = b.run(tp, to, 1, log=None, start=step)
    size = path.stat().st_size
    shutil.rmtree(path.parent)
    diff = max((x.float() - y.float()).abs().max().item()
               for t1, t2 in ((tp, p), (to, o))
               for x, y in zip(flatten(t1).values(), flatten(t2).values()))
    log(f"{tag} {cfg.name}: saved after step {CKPT_STEP} ({size / 2**20:.1f}"
        f" MiB in {save_s:.2f} s, loaded in {load_s:.2f} s); step "
        f"{CKPT_STEP + 1} resumed loss {got[0]:.7f} vs uninterrupted "
        f"{want[0]:.7f} (diff {abs(got[0] - want[0]):.3e}); max abs diff of "
        f"the parameters and AdamW state after it {diff:.3e} (required: 0)")
    if step != CKPT_STEP or got != want or diff != 0:
        _fail(f"{tag} the resumed step differs from the uninterrupted one")


def _train_launcher(tag):
    """(10e) ``python -m repro_torch.launch.train`` in a subprocess on the
    card (its default device): exit 0 and a final loss below its
    start."""
    cmd = [sys.executable, "-m", "repro_torch.launch.train",
           *LAUNCH_ARGS_10E]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    run = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=600)
    secs = time.perf_counter() - t0
    if run.returncode != 0:
        _fail(f"{tag} launch.train exited {run.returncode}: "
              f"{run.stderr[-2000:]}")
    m = re.search(r"final loss (\S+) \(start (\S+)\)", run.stdout)
    log(f"{tag} python -m repro_torch.launch.train "
        f"{' '.join(LAUNCH_ARGS_10E)}: exit 0 in {secs:.1f} s; "
        f"{m.group(0) if m else 'no final loss printed'}")
    if not m or not float(m.group(1)) < float(m.group(2)):
        _fail(f"{tag} launch.train's loss did not fall: {run.stdout[-500:]}")


def phase_train(torch):
    """Training on the card: (10a) llama3-8b at full width cut to
    ``TRAIN_LAYERS`` layers; (10b) the gradient check; (10c) mamba2-780m
    and whisper-base at full width and depth (each run of 10a and 10c
    profiled for one extra step); (10d) the checkpoint round trip; (10e) the launcher. No kernel
    of the repo runs in training."""
    from repro_torch.configs import get_config
    full = get_config("llama3-8b")
    _train_run(torch, "[phase 10a]",
               dataclasses.replace(full, n_layers=TRAIN_LAYERS), full,
               TRAIN_STEPS, TRAIN_OPT)
    _free(torch)
    _grad_check(torch)
    _free(torch)
    for arch in TRAIN_FAMILIES:
        cfg = get_config(arch)
        _train_run(torch, f"[phase 10c] {arch}", cfg, cfg, FAMILY_STEPS,
                   FAMILY_OPT)
        _free(torch)
    _ckpt_round_trip(torch)
    _free(torch)
    _train_launcher("[phase 10e]")


# ---------------------------------------------------------------------------
# phase 11: the dry-run, and its roofline held against the card
# ---------------------------------------------------------------------------

# (11a) the grid: every arch x input shape x both production meshes
GRID_CELLS, GRID_TIMEOUT = 96, 600
# (11b) llama3-8b on a one-card mesh, bf16 weights drawn on the card from
# seed 0: decode of 8 rows over 32768 positions (16.1 GB of weights, 34.4
# GB of KV) and one 8192-token prefill; the forward timed over
# ROOFLINE_CALLS synchronised calls after one warm-up
ROOFLINE_ARCH = "llama3-8b"
ROOFLINE_SHAPES = (("decode", 32768, 8, "decode"),
                   ("prefill", 8192, 1, "prefill"))
ROOFLINE_CALLS = 5
# the card's allocation within 1% of the predicted argument bytes; the
# measured time at least 0.9 of the larger roofline term
ALLOC_RTOL, ROOFLINE_FLOOR = 0.01, 0.9


def _dryrun_grid(tag):
    """(11a) ``python -m repro_torch.launch.sweep`` over the twelve archs
    x four shapes x both meshes in a subprocess (the meta device: the
    host's CPU); every cell must be ``ok``."""
    from repro_torch.configs import ARCH_IDS
    out = ROOT / "build" / "phase11a"
    shutil.rmtree(out, ignore_errors=True)
    cmd = [sys.executable, "-m", "repro_torch.launch.sweep", "--archs",
           ",".join(ARCH_IDS), "--both-meshes", "--out", str(out)]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    run = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=GRID_TIMEOUT)
    secs = time.perf_counter() - t0
    summary = out / "summary.json"
    reports = json.loads(summary.read_text()) if summary.exists() else []
    shutil.rmtree(out, ignore_errors=True)
    log(f"{tag} python -m repro_torch.launch.sweep --archs <all "
        f"{len(ARCH_IDS)}> --both-meshes: exit {run.returncode} in "
        f"{secs:.1f} s on the host (meta device); predictions in H100 "
        f"units, per card of an even partition")
    log(f"{tag} arch shape mesh: argument GiB/card, t_compute ms, "
        f"t_memory ms, bottleneck, useful_flops_ratio")
    for r in reports:
        if r.get("status") != "ok":
            log(f"{tag} {r.get('arch')} {r.get('shape')} {r.get('mesh')}: "
                f"{r.get('status')} {r.get('error')}")
            continue
        log(f"{tag} {r['arch']} {r['shape']} {r['mesh']}: "
            f"{r['mem_argument_size_in_bytes'] / 2**30:.3f} GiB, "
            f"{r['t_compute'] * 1e3:.3f} ms, {r['t_memory'] * 1e3:.3f} ms, "
            f"{r['bottleneck']}, {r['useful_flops_ratio']:.4f}")
    n_ok = sum(r.get("status") == "ok" for r in reports)
    log(f"{tag} {n_ok}/{len(reports)} cells ok")
    if run.returncode != 0 or n_ok != GRID_CELLS:
        _fail(f"{tag} {n_ok}/{GRID_CELLS} cells ok (exit "
              f"{run.returncode}): {run.stderr[-2000:]}")


def _on_card(torch, cfg, shape, specs):
    """The step's arguments on the card, with the specs' shapes and
    dtypes: weights drawn from seed 0 (the port's init, cast to each
    leaf's dtype), the cache zeroed (positions -1), tokens from numpy
    seed 0, and positions covering the whole cache (decode: the next
    token of full rows; prefill: an empty cache)."""
    from repro_torch.models.api import param_shapes
    from repro_torch.models.transformer import draw_params
    gen = torch.Generator(device="cuda").manual_seed(0)
    drawn = draw_params(param_shapes(cfg), torch.bfloat16, generator=gen,
                        device="cuda")

    def cast(tree, spec):
        return {k: cast(v, spec[k]) if isinstance(v, dict)
                else v.to(spec[k].dtype) for k, v in tree.items()}

    def zeros(tree):
        return {k: zeros(v) if isinstance(v, dict) else
                torch.full(v.shape, -1 if k == "pos" else 0, dtype=v.dtype,
                           device="cuda") for k, v in tree.items()}
    params = cast(drawn, specs.args[0])
    del drawn
    b, s_kv = specs.args[4].shape
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, tuple(specs.args[2].shape)).astype(
        np.int32)).cuda()
    decode = shape.kind == "decode"
    cache_len = torch.full((b,), s_kv - 1 if decode else 0,
                           dtype=torch.int32, device="cuda")
    kv_pos = torch.arange(s_kv, dtype=torch.int32,
                          device="cuda")[None].repeat(b, 1)
    return params, zeros(specs.args[1]), tokens, cache_len, kv_pos


def _roofline_check(torch, tag, cfg, shape, mesh):
    """(11b) One shape of llama3-8b on the card against its dry-run: the
    allocation against the predicted argument bytes, the FLOPs counted on
    the card against the calibrated count, and the median forward time
    against the larger roofline term."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.launch.dryrun import dryrun_report
    from repro_torch.launch.roofline import ByteCounter
    from repro_torch.launch.specs import make_serve_specs
    t0 = time.perf_counter()
    rep = dryrun_report(cfg, shape, mesh)
    step, specs = make_serve_specs(cfg, shape, mesh, multi_pod=False)
    pred = rep["mem_argument_size_in_bytes"]
    bound = max(rep["t_compute"], rep["t_memory"])
    log(f"{tag} {cfg.name} {shape.name}: batch {shape.global_batch} x "
        f"{shape.seq_len} on mesh {mesh.shape}; dry-run in "
        f"{time.perf_counter() - t0:.2f} s on the host: argument "
        f"{pred / 1e9:.3f} GB, {rep['flops_global']} FLOPs, "
        f"{rep['bytes_per_device']:.6e} bytes; t_compute "
        f"{rep['t_compute'] * 1e3:.3f} ms, t_memory "
        f"{rep['t_memory'] * 1e3:.3f} ms ({rep['bottleneck']}-bound)")
    _free(torch)
    base = torch.cuda.memory_allocated()
    args = _on_card(torch, cfg, shape, specs)
    torch.cuda.synchronize()
    alloc = torch.cuda.memory_allocated() - base
    rel = abs(alloc - pred) / pred
    torch.cuda.reset_peak_memory_stats()

    def calls():
        with torch.no_grad():
            step(*args)                              # warm-up
            torch.cuda.synchronize()
            times = []
            for _ in range(ROOFLINE_CALLS):
                t = time.perf_counter()
                logits, _ = step(*args)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t)
            with FlopCounterMode(display=False) as fc, ByteCounter() as bc:
                step(*args)
        return logits, times, fc.get_total_flops(), bc.total
    (logits, times, flops, nbytes), _, launches = _counted(torch, calls)
    peak = torch.cuda.max_memory_allocated() - base - alloc
    med = statistics.median(times)
    ratio = med / bound
    want_shape = (shape.global_batch,
                  1 if shape.kind == "decode" else shape.seq_len,
                  cfg.vocab_size)
    got_shape = tuple(logits.shape)
    finite = bool(torch.isfinite(logits).all())
    log(f"{tag} on the card: memory_allocated {alloc / 1e9:.3f} GB for "
        f"the weights, the zeroed cache and the inputs (predicted "
        f"{pred / 1e9:.3f} GB, off by {rel:.3e}; tol {ALLOC_RTOL}); "
        f"FlopCounterMode {flops} FLOPs (dry-run {rep['flops_global']}, "
        f"{'equal' if flops == rep['flops_global'] else 'DIFFERENT'}); "
        f"bytes counted on the card {nbytes:.6e} (dry-run "
        f"{rep['bytes_per_device']:.6e})")
    log(f"{tag} forward ms {[round(1e3 * t, 3) for t in times]}, median "
        f"{1e3 * med:.3f} ms = {ratio:.4f} x max(t_compute, t_memory) "
        f"{1e3 * bound:.3f} ms (floor {ROOFLINE_FLOOR}); peak "
        f"{peak / 2**30:.2f} GiB over the arguments' {alloc / 2**30:.2f} "
        f"GiB; logits "
        f"{got_shape} finite {finite}; launches {launches}")
    del args, logits
    _free(torch)
    if rel > ALLOC_RTOL:
        _fail(f"{tag} allocated {alloc} bytes against {pred} predicted")
    if flops != rep["flops_global"]:
        _fail(f"{tag} the card counted {flops} FLOPs, the dry-run "
              f"{rep['flops_global']}")
    if ratio < ROOFLINE_FLOOR:
        _fail(f"{tag} the card beat the roofline: {ratio:.4f} x the bound")
    if got_shape != want_shape or not finite:
        _fail(f"{tag} logits of shape {got_shape} (want {want_shape}), "
              f"finite {finite}")
    if any(launches.values()):
        _fail(f"{tag} a kernel of the repo launched: {launches}")
    return ratio


def phase_dryrun(torch):
    """(11a) the dry-run grid on the host; (11b) llama3-8b's roofline on
    a one-card mesh held against the card. No kernel of the repo runs
    here."""
    from repro_torch.configs import InputShape, get_config
    from repro_torch.launch.mesh import LogicalMesh
    _dryrun_grid("[phase 11a]")
    cfg = get_config(ROOFLINE_ARCH)
    mesh = LogicalMesh({"data": 1, "model": 1})
    for args in ROOFLINE_SHAPES:
        _roofline_check(torch, f"[phase 11b] {args[0]}", cfg,
                        InputShape(*args), mesh)


# ``launches`` counts calls of the op; ``kernels_per_launch`` is measured
# in phase 3's profiled calls, as the device kernels named by
# DEVICE_KERNELS over the op's launches there
KERNELS = {
    "paged_decode_attention": dict(
        source="src/repro_torch/kernels/csrc/paged_attention.cu",
        replaces="src/repro/kernels/paged_attention.py:65"),
    "chunked_prefill_attention": dict(
        source="src/repro_torch/kernels/csrc/chunked_prefill_attention.cu",
        replaces="src/repro/kernels/chunked_prefill_attention.py:80"),
}
DEVICE_KERNELS = {
    "paged_decode_attention": r"cronus::.*\b(split_kernel|merge_kernel)<",
    "chunked_prefill_attention":
        r"cronus::.*\b(tc::kernel|chunked_prefill_kernel)<",
}


def main() -> int:
    """Run the phases; exit 0 only if every phase passed."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default="1,2,3,4,5,6,7,8,9,10,11",
                    help="phases to run after phase 1 (2: kernels alone)")
    args = ap.parse_args()
    phases = {int(p) for p in args.phases.split(",")}

    import repro_torch  # noqa: F401  (fails outside a checkout)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t_start = time.perf_counter()
    secs = {}           # phase -> wall seconds

    def timed(phase, fn, *a):
        t0 = time.perf_counter()
        out = fn(*a)
        secs[phase] = round(time.perf_counter() - t0, 1)
        return out

    timed(1, phase_env_build, torch)
    rows = timed(2, phase_kernels, torch) if 2 in phases else {}
    launches, per_launch, step_ms = (timed(3, phase_main_path, torch)
                                     if 3 in phases else ({}, {}, None))
    if 4 in phases:
        timed(4, phase_parity, torch)
    if 5 in phases:
        for name, n in timed(5, phase_surface, torch).items():
            launches[name] = launches.get(name, 0) + n
    if 6 in phases:
        timed(6, phase_slot, torch, step_ms)
    if 7 in phases:
        for name, n in timed(7, phase_families, torch).items():
            launches[name] = launches.get(name, 0) + n
    if 8 in phases:
        timed(8, phase_moe, torch)
    if 9 in phases:
        timed(9, phase_ssm, torch)
    if 10 in phases:
        timed(10, phase_train, torch)
    if 11 in phases:
        timed(11, phase_dryrun, torch)
    log(f"[done] phases {sorted(phases)} passed in "
        f"{time.perf_counter() - t_start:.1f} s (seconds by phase: {secs})")

    kernels = []
    for name, meta in KERNELS.items():
        row = dict(name=name, route="cuda", **meta,
                   kernels_per_launch=per_launch.get(name),
                   launches=launches.get(name))
        row.update(rows.get(name, {}))
        kernels.append(row)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
