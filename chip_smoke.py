"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py [--phases 1,2,3,4,5,6]

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
   bf16: max abs error beside its tolerance, kernel / plain / library
   times from CUDA events, and the least time the card could take;
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
   2 layers on the same weights and trace, held to phase 4's rule.

The line before the last is a JSON object with one entry per kernel
(``launches`` counts phases 3 and 5); the last line is ``{"ok": true,
"device": {...}}``. Without a CUDA device the script exits with code 1
and prints no result.
"""
from __future__ import annotations

import argparse
import collections
import dataclasses
import gc
import json
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


def _decode_inputs(torch, dtype, rng):
    """Full-width decode step: B=8, H=32, Kv=8, D=128, page=16, ragged
    context up to 2048 with one ctx=0 lane, trash-padded tables."""
    b, h, kvh, d, page, max_pages = 8, 32, 8, 128, 16, 128
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


def _prefill_inputs(torch, dtype, rng, window):
    """Full-width prefill chunk: B=1, C=512, H=32, Kv=8, D=128, S=2048,
    the last chunk of a 2048-token prompt."""
    b, c, h, kvh, d, s = 1, 512, 32, 8, 128, 2048
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
    kv_pos = -1 tail, window 256). Returns the failures: an element
    outside its tolerance."""
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
                (2, 32, 2, 128, 200, 16, 40, [640, 257])]:     # G = 16
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


def phase_kernels(torch):
    """Each kernel against its plain version; returns the bf16 rows of the
    kernels JSON line (without launches). Every check runs, and every time
    is taken, before a failure ends the phase."""
    from repro_torch.kernels import (chunked_prefill_attention, ops,
                                     paged_attention)
    failures = _sweep(torch)
    flush = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device="cuda")
    rows = {}
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        rng = np.random.default_rng(0)

        args, nbytes, flops = _decode_inputs(torch, dtype, rng)
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
        log(f"[phase 2] paged_decode {dname}: max_abs_err {err:.3e} max "
            f"err/tol {ratio:.3f} ({_tol_text(dname)}) ctx=0 lane max|out| "
            f"{zero_lane} kernel_ms {k_ms:.4f} plain_ms {p_ms:.4f} "
            f"library_ms none (needs a gather) bound_ms {b_ms:.4f} ({b_by})")
        if not (ratio <= 1.0) or zero_lane != 0.0:
            failures.append(f"paged_decode {dname} disagrees with its plain "
                            f"version")
        if dtype == torch.bfloat16:
            rows["paged_decode_attention"] = dict(
                max_abs_err=err, ms=k_ms, plain_ms=p_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=None)

        for window in (0, 256):
            args, nbytes, flops, valid = _prefill_inputs(torch, dtype, rng,
                                                         window)
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
            # library yardstick: SDPA with the same mask and GQA grouping
            q, k, v = (t.transpose(1, 2) for t in args[:3])
            mask = valid[:, None]

            def sdpa():
                return torch.nn.functional.scaled_dot_product_attention(
                    q, k, v, attn_mask=mask, enable_gqa=True)
            lib_err = (sdpa().transpose(1, 2).float()
                       - want.float()).abs().max().item()
            l_ms = _time_ms(torch, sdpa, flush)
            b_ms, b_by = _bound(nbytes, flops, dname)
            log(f"[phase 2] chunked_prefill {dname} window={window}: "
                f"max_abs_err {err:.3e} max err/tol {ratio:.3f} "
                f"({_tol_text(dname)}) kernel_ms {k_ms:.4f} plain_ms "
                f"{p_ms:.4f} library_ms {l_ms:.4f} (sdpa err {lib_err:.2e}) "
                f"bound_ms {b_ms:.4f} ({b_by})")
            if not (ratio <= 1.0):
                failures.append(f"chunked_prefill {dname} window={window} "
                                f"disagrees with its plain version")
            if dtype == torch.bfloat16 and window == 0:
                rows["chunked_prefill_attention"] = dict(
                    max_abs_err=err, ms=k_ms, plain_ms=p_ms, bound_ms=b_ms,
                    bound_by=b_by, library_ms=l_ms)
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

def make_requests(n, vocab, seed=0, output_len=32):
    """``n`` prompts of 256-2048 tokens from a numpy seed, all at t=0."""
    from repro_torch.core.request import Request
    rng = np.random.default_rng(seed)
    lens = rng.integers(256, 2049, n)
    return [Request(req_id=f"r{i}",
                    prompt=rng.integers(0, vocab, int(n_tok)).astype(
                        np.int32),
                    output_len=output_len, arrival=0.0)
            for i, n_tok in enumerate(lens)]


def build_pair(cfg, factory):
    """The slice's Cronus pair: llama3-8b, A100 CPI + A10 PPI clocks."""
    from repro_torch.serving import hardware
    from repro_torch.serving.simulator import build_system
    return build_system("cronus", cfg, hardware.A100, hardware.A10,
                        executor_factory=factory, executor="paged",
                        block_size=16, max_batched_tokens=512, max_slots=16,
                        num_kv_blocks=2048)


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


def run_trace(torch, cfg, factory, n_requests, keep_logits=False,
              profile=None):
    """Serve ``n_requests`` through a fresh pair; returns the system, the
    per-engine recorders, the aggregate metrics and the wall seconds.
    ``profile`` maps an engine ("ppi"/"cpi") to its Recorder's profile."""
    system = build_pair(cfg, factory)
    recs = [Recorder(torch, role, e, keep_logits,
                     (profile or {}).get(role))
            for role, e in (("ppi", system.ppi), ("cpi", system.cpi))]
    reqs = make_requests(n_requests, cfg.vocab_size)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = system.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return system, recs, res, wall, reqs


def phase_main_path(torch, n_requests=N_REQUESTS):
    """Full-width llama3-8b Cronus serving; returns launches per kernel."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import chunked_prefill_attention, paged_attention
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
    chunked_prefill_attention.launches = 0
    paged_attention.launches = 0
    system, recs, res, wall, reqs = run_trace(torch, cfg, factory, n_requests,
                                              profile=PROFILE)
    launches = {"chunked_prefill_attention":
                chunked_prefill_attention.launches,
                "paged_decode_attention": paged_attention.launches}

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


def phase_parity(torch, n_requests=N_REQUESTS):
    """Kernels vs plain versions on the main path, 2 layers at full width."""
    from repro_torch.configs import get_config
    from repro_torch.serving.api import paged_executor_factory
    cfg = dataclasses.replace(get_config("llama3-8b"), n_layers=2,
                              dtype="bfloat16")
    runs = {}
    for use_kernels in (True, False):
        factory = paged_executor_factory(cfg, device="cuda",
                                         use_kernels=use_kernels)
        system, recs, res, _, _ = run_trace(torch, cfg, factory, n_requests,
                                            keep_logits=True)
        if res["completed"] != n_requests:
            _fail(f"parity run completed {res['completed']}/{n_requests}")
        runs[use_kernels] = {k: v for rec in recs
                             for k, v in rec.rows.items()}
        del system, recs, factory
        _free(torch)

    _compare_rows(runs[True], runs[False], "[phase 4] 2-layer full-width "
                  "parity, kernels vs plain versions")


def _compare_rows(got, want, what):
    """Hold two runs' emitted logits rows to each other: every compared
    step within ``LOGIT_TOL``; a token may differ only at a near-tie
    (both picks within ``GREEDY_TIE_MARGIN`` plus the step's logit
    difference of the top), after which that request is compared no
    further (the streams diverge)."""
    from repro_torch.core.executor import GREEDY_TIE_MARGIN
    if set(got) != set(want):
        _fail(f"{what}: the runs emitted different (request, token) sets")
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
                _fail(f"{what}: token {key} differs ({ta} vs {tb}) "
                      f"without a near-tie")
            ties += 1
            break                            # the streams diverge after
    log(f"{what}: {total} compared steps, max |logit diff| {max_diff:.4f} "
        f"(tol {LOGIT_TOL}), tokens agree {agree}/{total}, near-tie "
        f"divergences {ties}")
    if not (max_diff <= LOGIT_TOL):
        _fail(f"{what}: logits differ by {max_diff} > {LOGIT_TOL}")


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
    """llama3-8b weights drawn once on the card from seed 0."""
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
    requests through ``InferenceService.run``; every kernel count is set
    to 0 just before the run and read just after. ``profile`` maps an
    engine's name to its Recorder's profile. Returns the service, a
    Recorder per engine, the metrics, the wall seconds (host clock
    between two synchronises) and the launches."""
    from repro_torch.kernels import chunked_prefill_attention, paged_attention
    service = spec.build(model=model, device="cuda")
    recs = [Recorder(torch, e.name, e, profile=(profile or {}).get(e.name))
            for e in service.engines]
    reqs = make_requests(n_requests, model.cfg.vocab_size)
    chunked_prefill_attention.launches = 0
    paged_attention.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = service.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"chunked_prefill_attention":
                chunked_prefill_attention.launches,
                "paged_decode_attention": paged_attention.launches}
    return service, recs, res, wall, launches


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
        service, recs, res, wall, launches = _serve(torch, spec, model,
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

    cmd = [sys.executable, "-m", "repro_torch.launch.serve", *LAUNCH_ARGS]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    run = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=600)
    secs = time.perf_counter() - t0
    if run.returncode != 0:
        _fail(f"launch.serve exited {run.returncode}: {run.stderr[-2000:]}")
    metrics = json.loads(run.stdout)
    log(f"[phase 5] python -m repro_torch.launch.serve "
        f"{' '.join(LAUNCH_ARGS)}: exit 0 in {secs:.1f} s, completed "
        f"{metrics['completed']}, simulated-clock "
        + ", ".join(f"{k} {metrics[k]:.6g}" for k in AGG_KEYS))
    if metrics["completed"] != 4:
        _fail(f"launch.serve completed {metrics['completed']} of 4")
    return total


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
    service, recs, res, wall, launches = _serve(
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
    ap.add_argument("--phases", default="1,2,3,4,5,6",
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
    phase_env_build(torch)
    rows = phase_kernels(torch) if 2 in phases else {}
    launches, per_launch, step_ms = (phase_main_path(torch) if 3 in phases
                                     else ({}, {}, None))
    if 4 in phases:
        phase_parity(torch)
    if 5 in phases:
        for name, n in phase_surface(torch).items():
            launches[name] = launches.get(name, 0) + n
    if 6 in phases:
        phase_slot(torch, step_ms)
    log(f"[done] phases {sorted(phases)} passed in "
        f"{time.perf_counter() - t_start:.1f} s")

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
