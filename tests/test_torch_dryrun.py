"""The port's dry-run stack: partition rules against the JAX package's,
the FLOP and byte counters against exact hand counts and their own
full-depth runs, ``window_override`` against JAX's logits, the MoE
block's meta branch, the report's keys and the two entry points.

The dry-run is device-free by design: it runs the port's step on
``device="meta"``, so everything here runs on the CPU and allocates
nothing at full width.
"""
import dataclasses
import json
import math
import os
import subprocess
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro.configs import get_config as jax_get_config
from repro.configs import get_shape as jax_get_shape
from repro.launch import mesh as jax_mesh
from repro.launch import roofline as jax_roofline
from repro.models import build_model as jax_build_model
from repro.models import sharding as jax_sharding
from repro_torch.configs import (ARCH_IDS, INPUT_SHAPES, InputShape,
                                 get_config, get_shape)
from repro_torch.launch import dryrun, roofline
from repro_torch.launch.mesh import (LogicalMesh, make_production_mesh,
                                     sharding_rules)
from repro_torch.launch.roofline import ByteCounter, op_bytes
from repro_torch.launch.specs import make_serve_specs
from repro_torch.models import moe as moe_mod
from repro_torch.models import sharding
from repro_torch.models.api import build_model, param_shapes
from repro_torch.models.bridge import params_from_numpy
from repro_torch.models.layers import swiglu

ROOT = Path(__file__).resolve().parents[1]
META = torch.device("meta")
LOGIT_TOL = 1e-4


def _walk(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _walk(v, path + (k,))
        else:
            yield path + (k,), v


# ---------------------------------------------------------------------------
# (b) partition rules and parameter specs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCH_IDS)
def test_rules_and_param_pspecs_match_jax(arch):
    """``sharding_rules`` and ``param_pspec`` (before the divisibility
    fix) equal JAX's for every leaf, on both meshes."""
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    for multi_pod in (False, True):
        rules = sharding_rules(multi_pod, cfg)
        assert rules == jax_mesh.sharding_rules(multi_pod, jcfg)
        for path, shape in _walk(param_shapes(cfg)):
            leaf = types.SimpleNamespace(shape=shape)
            jpath = tuple(jax.tree_util.DictKey(k) for k in path)
            got = sharding.param_pspec(path, leaf, rules)
            want = jax_sharding.param_pspec(jpath, leaf, rules)
            assert tuple(got) == tuple(want), path


def test_divisible_spec_and_mesh_match_jax():
    mesh = make_production_mesh(multi_pod=True)
    assert mesh.shape == {"pod": 2, "data": 16, "model": 16}
    assert mesh.size == 512
    jmesh = jax.sharding.AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    cases = [(("pod", "data"), "model", None), (None, ("data", "model")),
             ("model", None, "data")]
    for spec in cases:
        for shape in ((32, 48, 7), (64, 16, 5), (3, 256, 16)):
            got = sharding.divisible_spec(sharding.P(*spec), shape, mesh)
            want = jax_sharding.divisible_spec(
                jax.sharding.PartitionSpec(*spec), shape, jmesh)
            assert tuple(got) == tuple(want)


# ---------------------------------------------------------------------------
# (c) MODEL_FLOPS
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCH_IDS)
def test_model_flops_match_jax(arch):
    for name in INPUT_SHAPES:
        assert (roofline.model_flops(get_config(arch), get_shape(name))
                == jax_roofline.model_flops(jax_get_config(arch),
                                            jax_get_shape(name)))


# ---------------------------------------------------------------------------
# (d) the calibrated extrapolation equals the full-depth count
# ---------------------------------------------------------------------------

FAMILIES = {
    "dense": ("llama3-8b", dict(n_layers=5)),
    "moe": ("kimi-k2-1t-a32b", dict(n_layers=5)),
    "mla": ("deepseek-v2-236b", dict(n_layers=5)),
    "ssm": ("mamba2-780m", dict(n_layers=5)),
    "hybrid": ("hymba-1.5b", dict(n_layers=5)),
    "encdec": ("whisper-base", dict(n_layers=4, n_enc_layers=3)),
}
SMALL_SHAPES = {
    "train": InputShape("train_4k", 32, 2, "train"),
    # 2048^2 score pairs: the blocked attention path
    "prefill": InputShape("prefill_32k", 2048, 1, "prefill"),
    "decode": InputShape("decode_32k", 96, 3, "decode"),
    # the sliding-window variant over a ring cache
    "long": InputShape("long_500k", 8192, 1, "decode"),
}


# the calibrated peak of temporary bytes against the full depth's: a
# peak, not a sum, it is not affine in depth (measured within 17%)
TEMP_TOL = 0.2


def _family_cfg(family):
    arch, deeper = FAMILIES[family]
    return dataclasses.replace(get_config(arch, smoke=True), **deeper)


@pytest.mark.parametrize("shape_key", list(SMALL_SHAPES))
@pytest.mark.parametrize("family", list(FAMILIES))
def test_calibrated_counts_equal_full_depth(family, shape_key):
    cfg = _family_cfg(family)
    if shape_key == "long":
        cfg = dataclasses.replace(cfg, swa_variant_window=64)
    shape = SMALL_SHAPES[shape_key]
    mesh = make_production_mesh()
    full = dryrun.step_counts(cfg, shape, mesh, False)
    cal = dryrun.calibrated_counts(cfg, shape, mesh, False)
    # every count is exact; the temporary bytes are a peak, which the
    # affine model follows to within TEMP_TOL
    temp = full.pop("temp"), cal.pop("temp")
    assert full == cal
    assert temp[1] == pytest.approx(temp[0], rel=TEMP_TOL)
    assert full["flops"] > 0 and full["bytes"] > 0


# ---------------------------------------------------------------------------
# (e) a dense forward's FLOPs by hand
# ---------------------------------------------------------------------------

def _dense_flops_by_hand(cfg, b, sq, skv, blocked):
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    t = b * sq
    gemms = (2 * t * d * (h + 2 * kv) * hd      # q, k, v projections
             + 2 * t * h * hd * d               # output projection
             + 3 * 2 * t * d * cfg.d_ff)        # SwiGLU
    if blocked:    # queries and keys padded to whole blocks of 512 / 1024
        bq, bk = min(512, sq), min(1024, skv)
        sq, skv = -(-sq // bq) * bq, -(-skv // bk) * bk
    attn = 2 * (2 * b * sq * skv * h * hd)      # QK^T and PV
    return cfg.n_layers * (gemms + attn) + 2 * t * d * cfg.vocab_size


@pytest.mark.parametrize("b,sq,skv,blocked", [
    (3, 1, 96, False), (2, 16, 64, False), (1, 2048, 2048, True),
    (1, 1500, 3000, True)])
def test_dense_flops_equal_hand_count(b, sq, skv, blocked):
    cfg = dataclasses.replace(get_config("llama3-8b", smoke=True),
                              n_layers=3)
    kind = "decode" if sq == 1 else "prefill"
    shape = InputShape(f"{kind}_x", skv, b, kind)
    mesh = make_production_mesh()
    step, specs = make_serve_specs(cfg, shape, mesh, multi_pod=False)
    if kind == "prefill" and sq != skv:
        # a chunk of sq tokens against a longer cache
        args = list(specs.args)
        args[2] = torch.empty((b, sq), dtype=torch.int32, device=META)
        specs.args = tuple(args)
    got = roofline.count_step(step, specs.args)["flops"]
    assert got == _dense_flops_by_hand(cfg, b, sq, skv, blocked)


# ---------------------------------------------------------------------------
# (f) and (h): the MoE block on meta and on the CPU
# ---------------------------------------------------------------------------

def _moe_params(cfg, device):
    shapes = moe_mod.moe_shapes(cfg, 1)
    gen = torch.Generator().manual_seed(0)

    def one(shape):
        t = torch.randn(shape[1:], generator=gen) * shape[-2] ** -0.5
        return t.to(device)
    return {k: ({kk: one(vv) for kk, vv in v.items()} if isinstance(v, dict)
                else one(v)) for k, v in shapes.items()}


@pytest.mark.parametrize("exact", [False, True])
@pytest.mark.parametrize("arch", ["kimi-k2-1t-a32b", "deepseek-v2-236b"])
def test_moe_meta_count_is_capacity_work(arch, exact):
    """On meta: ``E·C·6·d·f`` for the routed experts at capacity ``C``,
    plus the router and the shared experts, and nothing else."""
    cfg = dataclasses.replace(get_config(arch), n_layers=1)
    b, s = 4, 512
    t, d, f, e = b * s, cfg.d_model, cfg.d_ff, cfg.n_experts
    p = {k: ({kk: torch.empty(vv[1:], dtype=torch.bfloat16, device=META)
              for kk, vv in v.items()} if isinstance(v, dict) else
             torch.empty(v[1:], dtype=torch.bfloat16, device=META))
         for k, v in moe_mod.moe_shapes(cfg, 1).items()}
    x = torch.empty((b, s, d), dtype=torch.bfloat16, device=META)
    with FlopCounterMode(display=False) as fc:
        out, aux = moe_mod.moe_block(p, cfg, x, exact=exact)
    cap = moe_mod.capacity(t, cfg, exact)
    want = (e * cap * 6 * d * f + 2 * t * d * e
            + cfg.n_shared_experts * 6 * t * d * f)
    assert fc.get_total_flops() == want
    assert out.shape == x.shape and out.dtype == x.dtype
    assert aux.shape == () and aux.dtype == torch.float32


def _moe_block_before_branch(p, cfg, x, exact=False):
    """``moe_block`` as it was before the meta branch, kept verbatim."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    t = b * s
    xt = x.reshape(t, d)
    probs, gate_w, gate_idx = moe_mod.route(p, cfg, xt)
    ce = torch.bincount(gate_idx.reshape(-1), minlength=e).float() / (t * k)
    aux = e * torch.sum(probs.mean(0) * ce)
    pairs, kept, _ = moe_mod.dispatch(gate_idx, e,
                                      moe_mod.capacity(t, cfg, exact))
    tok = pairs // k
    xs = xt[tok]
    ys, off = [], 0
    for ei, n in enumerate(kept.tolist()):
        if n:
            ys.append(swiglu(xs[off:off + n], p["w_gate"][ei],
                             p["w_up"][ei], p["w_down"][ei]))
            off += n
    out = torch.zeros((t, d), dtype=torch.float32, device=x.device)
    if ys:
        w = gate_w.reshape(-1)[pairs].to(x.dtype).float()
        out.index_add_(0, tok, torch.cat(ys).float() * w[:, None])
    out = out.to(x.dtype)
    for i in range(cfg.n_shared_experts):
        sp = p[f"shared_{i}"]
        out = out + swiglu(xt, sp["w_gate"], sp["w_up"], sp["w_down"])
    return out.reshape(b, s, d), aux


@pytest.mark.parametrize("exact", [False, True])
@pytest.mark.parametrize("arch", ["kimi-k2-1t-a32b", "deepseek-v2-236b"])
def test_moe_block_on_cpu_is_unchanged(arch, exact, monkeypatch):
    """Real devices never take the meta branch: on the CPU the block is
    bit-equal to its code before the branch."""
    torch.use_deterministic_algorithms(True)
    try:
        cfg = get_config(arch, smoke=True)
        p = _moe_params(cfg, "cpu")
        x = torch.randn((2, 24, cfg.d_model),
                        generator=torch.Generator().manual_seed(1))
        want = _moe_block_before_branch(p, cfg, x, exact)

        def refuse(*a, **k):
            raise AssertionError("meta branch taken on the CPU")
        monkeypatch.setattr(moe_mod, "_capacity_block_meta", refuse)
        got = moe_mod.moe_block(p, cfg, x, exact)
    finally:
        torch.use_deterministic_algorithms(False)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


# ---------------------------------------------------------------------------
# (g) window_override against JAX
# ---------------------------------------------------------------------------

WINDOW, PREFILL, DECODE_STEPS = 4, 5, 3


@pytest.mark.parametrize("arch", ["llama3-8b", "whisper-base"])
def test_window_override_matches_jax(arch):
    """Every layer attends over the override's window: a prefill and 3
    decode steps on a ``window + 1`` ring cache (the third wraps it) give
    JAX's logits within 1e-4 (fp32, smoke), and differ from the run
    without the override."""
    cfg, jcfg = get_config(arch, smoke=True), jax_get_config(arch,
                                                             smoke=True)
    jmodel = jax_build_model(jcfg, window_override=WINDOW)
    jparams = jmodel.init_params(jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, jparams)
    params = params_from_numpy(tree, cfg, device="cpu")
    rng = np.random.default_rng(0)
    b = 2
    prompt = rng.integers(0, cfg.vocab_size, (b, PREFILL)).astype(np.int32)
    enc = (rng.standard_normal((b, cfg.enc_seq_len, cfg.d_model))
           .astype(np.float32) if cfg.enc_dec else None)

    def run_torch(window_override):
        model = build_model(cfg, params, device="cpu",
                            window_override=window_override)
        cache = model.init_cache(b, WINDOW + 1)
        kw = {}
        if enc is not None:
            kw["enc_out"] = model.encode(params, torch.from_numpy(enc))
        logits = []
        with torch.no_grad():
            toks = torch.from_numpy(prompt)
            lens = torch.zeros(b, dtype=torch.int32)
            for i in range(1 + DECODE_STEPS):
                out, cache, _ = model.forward(params, toks, cache, lens,
                                              decode=i > 0, **kw)
                kw = {}
                logits.append(out[:, -1].numpy())
                lens = lens + toks.shape[1]
                toks = out[:, -1:].argmax(-1).to(torch.int32)
        return logits

    def run_jax():
        cache = jmodel.init_cache(b, WINDOW + 1)
        kw = {}
        if enc is not None:
            kw["enc_out"] = jmodel.encode(jparams, jnp.asarray(enc))
        logits = []
        toks = jnp.asarray(prompt)
        lens = jnp.zeros((b,), jnp.int32)
        for i in range(1 + DECODE_STEPS):
            out, cache, _ = jmodel.forward(jparams, toks, cache, lens,
                                           decode=i > 0, **kw)
            kw = {}
            logits.append(np.asarray(out[:, -1]))
            lens = lens + toks.shape[1]
            toks = jnp.argmax(out[:, -1:], -1).astype(jnp.int32)
        return logits

    got, want = run_torch(WINDOW), run_jax()
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=LOGIT_TOL, atol=LOGIT_TOL)
    plain = run_torch(None)
    assert not np.allclose(plain[-1], got[-1], atol=10 * LOGIT_TOL)


# ---------------------------------------------------------------------------
# the byte counter
# ---------------------------------------------------------------------------

def test_byte_counter_charges_what_each_op_touches():
    big = torch.empty((1000, 64), dtype=torch.bfloat16, device=META)
    idx = torch.empty((10,), dtype=torch.int64, device=META)
    rows = 10 * 64 * 2
    with ByteCounter() as bc:
        v = big[:100].view(100, 64).t()                # views: nothing
    assert bc.total == 0 and v.shape == (64, 100)
    cases = [
        (lambda: big.index_select(0, idx), 2 * rows + 80),
        (lambda: big[idx], 2 * rows + 80),
        (lambda: big.index_copy_(0, idx, big[:10]), rows + 80 + rows),
        (lambda: big.index_add_(0, idx, big[:10]), rows + 80 + 2 * rows),
        (lambda: big.fill_(0), 1000 * 64 * 2),
        (lambda: torch.zeros_like(big[:10]), rows),
        (lambda: big[:10].copy_(big[10:20]), 2 * rows),
        (lambda: big[:10].float(), rows + 2 * rows),
        (lambda: big[:10] + big[0], rows + 64 * 2 + rows),
    ]
    for fn, want in cases:
        with ByteCounter() as bc:
            fn()
        assert bc.total == want
    cols = torch.arange(8, device=META)
    vals = torch.empty((10, 8), dtype=torch.bfloat16, device=META)
    with ByteCounter() as bc:
        big[idx[:, None], cols] = vals
    assert bc.total == 80 + 64 + 160 + 160        # indices, values, region
    with ByteCounter() as bc:
        big.index_put_((idx[:, None], cols), vals, accumulate=True)
    assert bc.total == 80 + 64 + 160 + 2 * 160    # the region read too


def test_byte_counter_sees_the_decode_cache_traffic():
    """A decode step of one layer moves at least its weights (bar the
    embedding table, of which it reads 4 rows) and its whole KV cache, and
    less than ten times them."""
    cfg = dataclasses.replace(get_config("llama3-8b"), n_layers=1)
    shape = InputShape("decode_x", 4096, 4, "decode")
    step, specs = make_serve_specs(cfg, shape, make_production_mesh(),
                                   multi_pod=False)
    weights = sum(roofline.tensor_bytes(t) for p, t in _walk(specs.args[0])
                  if p != ("embed",))
    cache = sum(roofline.tensor_bytes(t) for _, t in _walk(specs.args[1]))
    got = roofline.count_step(step, specs.args)["bytes"]
    assert weights + cache <= got < 10 * (weights + cache)
    # the embedding lookup reads 4 rows, not the 1 GB table
    emb = specs.args[0]["embed"]
    assert op_bytes(torch.ops.aten.index.Tensor, (emb, [specs.args[2]]), {},
                    emb[:4]) == 2 * 4 * cfg.d_model * 2 + 4 * 4


# ---------------------------------------------------------------------------
# the report and the entry points
# ---------------------------------------------------------------------------

class _Compiled:
    """Enough of a compiled XLA executable for JAX's ``roofline_report``."""

    def cost_analysis(self):
        return {"flops": 1.0, "bytes accessed": 1.0}

    def as_text(self):
        return ""

    def memory_analysis(self):
        return types.SimpleNamespace(
            argument_size_in_bytes=1, output_size_in_bytes=1,
            temp_size_in_bytes=1, generated_code_size_in_bytes=1)


# the one key with no counterpart: eager PyTorch generates no code
NULL_KEYS = ("mem_generated_code_size_in_bytes",)
FILLED_KEYS = ("collective_bytes_per_device", "collective_count",
               "t_collective", "mem_temp_size_in_bytes")


def test_report_keys_are_jax_keys():
    jax_keys = set(jax_roofline.roofline_report(_Compiled(), 4, 1.0))
    memo = {}
    rep = dryrun.run_one("whisper-base", "decode_32k", False,
                         verbose=False, memo=memo)
    extra = {"calibrated", "t_calibrate_s", "arch", "shape", "mesh",
             "status", "t_compile_s"}
    assert set(rep) == jax_keys | extra
    assert all(rep[k] is None for k in NULL_KEYS)
    assert all(rep[k] is not None and rep[k] >= 0 for k in FILLED_KEYS)
    assert set(rep["collective_ops"]) == set(jax_roofline._COLLECTIVES)
    assert sum(rep["collective_ops"].values()) \
        == rep["collective_bytes_per_device"]
    assert rep["t_collective"] == rep["collective_bytes_per_device"] \
        / roofline.LINK_BW
    assert rep["status"] == "ok" and rep["mesh"] == "16x16"
    terms = {"compute": rep["t_compute"], "memory": rep["t_memory"],
             "collective": rep["t_collective"]}
    assert rep["bottleneck"] == max(terms, key=terms.get)
    # per-card counts depend on the mesh: one memo entry each; the batch
    # splits twice as far over the pods, so each card's FLOPs halve
    mp = dryrun.run_one("whisper-base", "decode_32k", True, verbose=False,
                        memo=memo)
    assert len(memo) == 2 and mp["mesh"] == "2x16x16"
    assert mp["flops_global"] == rep["flops_global"]
    assert mp["flops_per_device"] * 2 == rep["flops_per_device"]


def test_argument_bytes_follow_the_partition_specs():
    cfg = get_config("llama3-8b")
    shape = get_shape("decode_32k")
    one = LogicalMesh({"data": 1, "model": 1})
    _, specs = make_serve_specs(cfg, shape, one, multi_pod=False)
    total = sum(roofline.tensor_bytes(t) for i in range(5)
                for _, t in _walk({"a": specs.args[i]}))
    assert dryrun.argument_bytes(specs, one) == total
    mesh = make_production_mesh()
    _, specs = make_serve_specs(cfg, shape, mesh, multi_pod=False)
    # no leaf is split more than 256 ways, and the norms are replicated
    per_card = dryrun.argument_bytes(specs, mesh)
    assert total / 256 < per_card < total / 16


def _env():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.pop("PYTHONSTARTUP", None)
    return env


def test_dryrun_cli_writes_a_report(tmp_path):
    out = tmp_path / "r.json"
    run = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "mamba2-780m", "--shape", "long_500k", "--multi-pod", "--out",
         str(out)], env=_env(), capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr
    rep = json.loads(out.read_text())
    assert rep["status"] == "ok" and rep["mesh"] == "2x16x16"
    assert rep["chips"] == 512 and rep["t_collective"] >= 0
    assert rep["mem_generated_code_size_in_bytes"] is None
    assert "roofline (H100)" in run.stdout


def test_sweep_cli_resumes_and_records_failures(tmp_path):
    argv = [sys.executable, "-m", "repro_torch.launch.sweep", "--out",
            str(tmp_path), "--archs", "whisper-base", "--shapes",
            "decode_32k,long_500k", "--both-meshes"]
    run = subprocess.run(argv, env=_env(), capture_output=True, text=True,
                         timeout=300)
    assert run.returncode == 0, run.stderr
    summary = json.loads((tmp_path / "summary.json").read_text())
    assert [r["status"] for r in summary] == ["ok"] * 4
    cell = tmp_path / "whisper-base__decode_32k__mp.json"
    cell.write_text(json.dumps({"status": "ok", "marker": 1}))
    run = subprocess.run(argv + ["--archs", "whisper-base,no-such-arch"],
                         env=_env(), capture_output=True, text=True,
                         timeout=300)
    assert run.returncode == 1
    summary = json.loads((tmp_path / "summary.json").read_text())
    assert summary[1] == {"status": "ok", "marker": 1}    # resumed
    fails = [r for r in summary if r["status"] == "fail"]
    assert len(fails) == 4 and "no-such-arch" in " ".join(fails[0]["error"])
    assert "4/8 OK" in run.stdout


def test_dryrun_allocates_nothing_at_full_width():
    """kimi-k2's 1 T parameters, counted on meta."""
    rep = dryrun.run_one("kimi-k2-1t-a32b", "decode_32k", False,
                         verbose=False)
    assert rep["mem_argument_size_in_bytes"] > 100 * 2**30
    assert math.isfinite(rep["t_memory"]) and rep["flops_global"] > 0
