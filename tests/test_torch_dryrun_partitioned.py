"""The partitioned dry-run: the port's step as ``DTensor``s over a
``DeviceMesh`` on a fake process group, against XLA's SPMD-partitioned
modules of the JAX package on the same 2x2 ``("data", "model")`` mesh.

The JAX reference runs this file as a script (``python
tests/test_torch_dryrun_partitioned.py OUT.json PARTS``) with four host
devices and a ``jax.sharding.Mesh`` built directly (auto axes: the
``jax.make_mesh`` of ``repro.launch.mesh`` gives explicit-sharding axes,
which JAX 0.9 refuses in the embedding gather); the test session's JAX
sees one device, so it runs in two subprocesses (the training steps,
and the rest), started with the module and read when a test needs
them. Its layer scans are unrolled, so every
layer's collectives are in the module, as the port counts every layer.

Cases:

(a) single ops with one right answer, equal to JAX's HLO in kind, bytes
    and count: a row-parallel product gives one all-reduce of its
    output; the MoE ``shard_map`` block one all-reduce of the partial
    (after the router's two statistics, which JAX sums outside it).
    A vocabulary-split embedding lookup is printed for both (GSPMD and
    DTensor may move different things);
(b) whole steps (decode, prefill, train) of eight archs at smoke width:
    the port's collective bytes per card within ``BAND`` of JAX's, or a
    named departure (``ROADMAP.md`` queue 3) whose measured ratio is
    pinned in ``DEPARTURES``;
(c) four gloo processes on the CPU run smoke steps on real tensors,
    issue exactly the collectives that the fake mesh counts, and compute
    the logits (or the loss and AdamW's first moments, the gradients)
    that one process does;
(d) per-card FLOPs times the cards equal one card's count where every
    product splits, and the per-card argument bytes of the ``DTensor``s
    equal ``argument_bytes``;
(e) the fake group is gone after a dry-run, and after one that raises;
(f) the calibrated collective bytes and count equal a full-depth count
    at 3 and 4 layers;
(g) where the model axis divides the heads, the SSM core moves columns
    by all-to-all and gathers nothing.
"""
import dataclasses
import functools
import json
import os
import subprocess
import sys
from pathlib import Path

if __name__ == "__main__":      # the JAX reference: four host devices
    # (the backend's code is never run: its optimisation passes are off,
    # which leaves the partitioned HLO and its collectives as they are)
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count=4"
                               " --xla_backend_optimization_level=0"
                               " --xla_llvm_disable_expensive_passes=true")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402
import torch.multiprocessing as mp  # noqa: E402

from repro.configs import InputShape as JaxInputShape  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.launch import roofline as jax_roofline  # noqa: E402
from repro_torch.configs import InputShape, get_config  # noqa: E402
from repro_torch.launch import dryrun, roofline  # noqa: E402
from repro_torch.launch.mesh import (LogicalMesh, fake_mesh,  # noqa: E402
                                     init_gloo, process_mesh,
                                     sharding_rules)
from repro_torch.launch.roofline import COLLECTIVE_KINDS  # noqa: E402
from repro_torch.launch.specs import distribute, make_specs  # noqa: E402
from repro_torch.models import sharding  # noqa: E402
from repro_torch.models.layers import embed  # noqa: E402
from repro_torch.models.moe import ep_moe  # noqa: E402
from repro_torch.training.tree import flatten  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
MESH, AXES = (2, 2), ("data", "model")
LOGICAL = LogicalMesh(dict(zip(AXES, MESH)))
ARCHS = ("llama3-8b", "qwen3-32b", "gemma3-27b", "deepseek-v2-236b",
         "kimi-k2-1t-a32b", "mamba2-780m", "hymba-1.5b", "whisper-base")
KINDS = ("decode", "prefill", "train")
SHAPE_NAMES = {"decode": "decode_32k", "prefill": "prefill_32k",
               "train": "train_4k"}
SEQ, BATCH = 256, 8
# the port's collective bytes per card over JAX's: within this band, or
# a named departure
BAND = (0.5, 2.0)
# (arch, kind) -> the measured ratio, pinned to RATIO_TOL (ROADMAP.md
# queue 3): the dense decode steps write the cache with no collective
# (JAX moves each new token's K/V by all-to-all)
DEPARTURES = {
    ("llama3-8b", "decode"): 0.24939,
    ("qwen3-32b", "decode"): 0.24939,
    ("gemma3-27b", "decode"): 0.24939,
    ("whisper-base", "decode"): 0.33258,
}
RATIO_TOL = 1e-3
JAX_TIMEOUT = 600
# the MoE block of (a): kimi-k2's smoke width, 16 tokens, top-k of E
MOE_ARCH, MOE_T = "kimi-k2-1t-a32b", 16
# (a): the row-parallel product h [8, 32] @ w [32, 16], fp32
ROW_H, ROW_W = (8, 32), (32, 16)
# (a): the embedding of ids [8, 4] in a [64, 16] fp32 table
EMB_TABLE, EMB_IDS = (64, 16), (8, 4)
# (c): each run's logits (or loss and first moments) against one
# process's, fp32
VALUE_RTOL, VALUE_ATOL = 1e-4, 1e-5
# (c): the steps the gloo ranks run (each over its own blocks): a dense
# and an SSM step with their backward and AdamW, and one decode step of
# each region kind (MLA and the MoE body, the SSM core by heads and its
# column exchange, whisper's rows)
GLOO_STEPS = (("llama3-8b", "train"), ("mamba2-780m", "train"),
              ("deepseek-v2-236b", "decode"), ("mamba2-780m", "decode"),
              ("whisper-base", "decode"))


def _shape(kind):
    return InputShape(SHAPE_NAMES[kind], SEQ, BATCH, kind)


# ---------------------------------------------------------------------------
# the JAX reference (run as a script)
# ---------------------------------------------------------------------------

def _jax_counts(compiled):
    c = jax_roofline.collective_bytes(compiled.as_text())
    return {k: c[k] for k in COLLECTIVE_KINDS} | {"count": c["count"]}


def _jax_reference(out_path, parts):
    """JAX's counts of ``parts`` (``"ops"``, the single ops, and step
    kinds) to ``out_path``."""
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as JP

    from repro.launch.mesh import sharding_rules as jax_rules
    from repro.launch.specs import make_serve_specs, make_train_specs
    from repro.models import sharding as jax_sharding
    from repro.models.moe import _moe_dispatch_shardmap

    mesh = jax.sharding.Mesh(np.array(jax.devices()).reshape(MESH), AXES)
    out = {}

    def ns(*spec):
        return NamedSharding(mesh, JP(*spec))

    if "ops" in parts:
        row = jax.jit(lambda h, w: h @ w, in_shardings=(
            ns("data", "model"), ns("model", None)),
            out_shardings=ns("data", None))
        out["row"] = _jax_counts(row.lower(
            jax.ShapeDtypeStruct(ROW_H, jnp.float32),
            jax.ShapeDtypeStruct(ROW_W, jnp.float32)).compile())

        emb = jax.jit(lambda t, i: t[i], in_shardings=(
            ns("model", None), ns("data", None)),
            out_shardings=ns("data", None, None))
        out["embed"] = _jax_counts(emb.lower(
            jax.ShapeDtypeStruct(EMB_TABLE, jnp.float32),
            jax.ShapeDtypeStruct(EMB_IDS, jnp.int32)).compile())

        cfg = jax_get_config(MOE_ARCH, smoke=True)
        rules = {"batch": ("data",), "experts": "model", "model": "model"}
        e, d, f, k = cfg.n_experts, cfg.d_model, cfg.d_ff, cfg.top_k

        def block(xt, gw, gi, wg, wu, wd):
            return _moe_dispatch_shardmap(
                {"w_gate": wg, "w_up": wu, "w_down": wd}, cfg, xt, gw, gi,
                mesh, rules)
        moe = jax.jit(block, in_shardings=(
            ns("data", None), ns("data", None), ns("data", None),
            ns("model", None, None), ns("model", None, None),
            ns("model", None, None)))
        with mesh:
            out["moe"] = _jax_counts(moe.lower(
                jax.ShapeDtypeStruct((MOE_T, d), jnp.float32),
                jax.ShapeDtypeStruct((MOE_T, k), jnp.float32),
                jax.ShapeDtypeStruct((MOE_T, k), jnp.int32),
                jax.ShapeDtypeStruct((e, d, f), jnp.float32),
                jax.ShapeDtypeStruct((e, d, f), jnp.float32),
                jax.ShapeDtypeStruct((e, f, d), jnp.float32)).compile())

    for arch in ARCHS:
        jcfg = jax_get_config(arch, smoke=True)
        for kind in (k for k in KINDS if k in parts):
            shape = JaxInputShape(SHAPE_NAMES[kind], SEQ, BATCH, kind)
            jax_sharding.set_rules(jax_rules(False, jcfg), mesh)
            try:
                if kind == "train":
                    step, specs = make_train_specs(
                        jcfg, shape, mesh, multi_pod=False, scan_unroll=True)
                    donate = (0, 1)
                else:
                    step, specs = make_serve_specs(
                        jcfg, shape, mesh, multi_pod=False, scan_unroll=True)
                    donate = (1,)
                with mesh:
                    out[f"{arch}/{kind}"] = _jax_counts(jax.jit(
                        step, donate_argnums=donate).lower(*specs).compile())
            finally:
                jax_sharding.set_rules(None)
    Path(out_path).write_text(json.dumps(out))


@pytest.fixture(scope="module", autouse=True)
def jax_ref(tmp_path_factory):
    """JAX's counts, from the script started once for the module, before
    its first test (the tests that need no JAX run while it compiles)."""
    tmp = tmp_path_factory.mktemp("jax")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu")
    # two processes: the training steps take as long as the rest
    procs = {tmp / f"{i}.json": subprocess.Popen(
        [sys.executable, __file__, str(tmp / f"{i}.json"), parts],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for i, parts in enumerate(("ops,decode,prefill", "train"))}
    cache = {}

    def get():
        if not cache:
            for path, proc in procs.items():
                _, err = proc.communicate(timeout=JAX_TIMEOUT)
                assert proc.returncode == 0, err[-3000:]
                cache.update(json.loads(path.read_text()))
        return cache
    yield get
    for proc in procs.values():
        if proc.poll() is None:
            proc.kill()


def _port(counts):
    return {k: counts[k] for k in COLLECTIVE_KINDS} \
        | {"count": counts["coll_count"]}


def _count(fn, *args):
    with roofline.CollectiveCounter() as cc:
        fn(*args)
    return {k: cc.bytes[k] for k in COLLECTIVE_KINDS} | {"count": cc.count}


def _meta(shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


# ---------------------------------------------------------------------------
# (c) a real run on four gloo processes
# ---------------------------------------------------------------------------

def _real(t, gen):
    """A tensor of ``t``'s shape and dtype on the CPU: random floats, and
    integers in a range every index argument takes (0 = cache length,
    token 0, position 0)."""
    if t.is_floating_point():
        return torch.randn(t.shape, generator=gen).to(t.dtype) * 0.1
    return torch.zeros(t.shape, dtype=t.dtype)


def _whole(tree, gen):
    if isinstance(tree, dict):
        return {k: _whole(v, gen) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_whole(v, gen) for v in tree)
    return _real(tree, gen)


def _result(kind, out):
    """The values a step's run is held to: a serving step's logits, a
    training step's loss and AdamW's first moments (a tenth of each
    gradient leaf, after clipping)."""
    if kind != "train":
        return {"logits": out[0]}
    return {"loss": out[-1]} | {f"m/{k}": v
                                for k, v in flatten(out[1]["m"]).items()}


def _one_process(arch, kind):
    """The step's value on whole tensors in one process (no rules)."""
    cfg = get_config(arch, smoke=True)
    step, specs = make_specs(cfg, _shape(kind), LOGICAL, multi_pod=False)
    gen = torch.Generator().manual_seed(0)
    return _result(kind, step(*_whole(specs.args, gen)))


def _gloo_rank(rank, store, out_dir):
    init_gloo(f"file://{store}", rank, 4)
    try:
        mesh = process_mesh(MESH, AXES, "cpu")
        for arch, kind in GLOO_STEPS:
            cfg = get_config(arch, smoke=True)
            step, specs = make_specs(cfg, _shape(kind), LOGICAL,
                                     multi_pod=False)
            gen = torch.Generator().manual_seed(0)
            args = distribute(_whole(specs.args, gen), specs.pspecs, mesh)
            sharding.set_rules(sharding_rules(False, cfg), mesh)
            try:
                from torch.distributed.tensor.experimental import \
                    implicit_replication
                with implicit_replication(), \
                        roofline.CollectiveCounter() as cc:
                    res = _result(kind, step(*args))
                res = {k: v.full_tensor() for k, v in res.items()}
            finally:
                sharding.set_rules(None)
            (Path(out_dir) / f"{arch}_{kind}_{rank}.json").write_text(
                json.dumps(cc.ops))
            if rank == 0:
                torch.save(res, Path(out_dir) / f"{arch}_{kind}.pt")
    finally:
        dist.destroy_process_group()


@functools.lru_cache(maxsize=None)
def _fake_ops(arch, kind, shape=MESH, rank=0):
    """The collectives of a smoke step as ``rank`` of a fake mesh of
    ``shape`` over ``AXES``, in order, counted once per process."""
    cfg = get_config(arch, smoke=True)
    step, specs = make_specs(cfg, _shape(kind), LogicalMesh(
        dict(zip(AXES, shape))), multi_pod=False)
    with fake_mesh(shape, AXES, device_type="cpu", rank=rank) as mesh:
        sharding.set_rules(sharding_rules(False, cfg), mesh)
        try:
            from torch.distributed.tensor.experimental import \
                implicit_replication
            with implicit_replication(), roofline.CollectiveCounter() as cc:
                step(*distribute(specs.args, specs.pspecs, mesh))
        finally:
            sharding.set_rules(None)
    return [list(op) for op in cc.ops]


def test_gloo_ranks_issue_the_counted_collectives(tmp_path):
    ctx = mp.start_processes(_gloo_rank, args=(tmp_path / "store", tmp_path),
                             nprocs=4, start_method="spawn", join=False)
    # each rank's own count: the SSM core's exchange moves a different
    # number of columns to each card
    want = {(step, rank): _fake_ops(*step, MESH, rank)
            for step in GLOO_STEPS for rank in range(4)}
    value = {step: _one_process(*step) for step in GLOO_STEPS}
    while not ctx.join():
        pass
    for arch, kind in GLOO_STEPS:
        for rank in range(4):
            got = json.loads(
                (tmp_path / f"{arch}_{kind}_{rank}.json").read_text())
            assert got == want[(arch, kind), rank], (arch, kind, rank)
            assert got, (arch, kind, rank)
        # the partitioned run computes what one process does (fp32: the
        # ranks sum their partial products in another order)
        got = torch.load(tmp_path / f"{arch}_{kind}.pt")
        assert got.keys() == value[arch, kind].keys()
        for name, v in value[arch, kind].items():
            torch.testing.assert_close(got[name], v, rtol=VALUE_RTOL,
                                       atol=VALUE_ATOL,
                                       msg=f"{arch} {kind} {name}")


# ---------------------------------------------------------------------------
# (d) per-card counts
# ---------------------------------------------------------------------------

def test_per_card_flops_and_argument_bytes():
    """llama3-8b at full width, one layer: every product splits over the
    2x2 mesh (batch over data; heads, ff and vocabulary over model)."""
    cfg = dataclasses.replace(get_config("llama3-8b"), n_layers=1)
    one = LogicalMesh({"data": 1, "model": 1})
    for shape in (InputShape("decode_32k", 1024, 8, "decode"),
                  InputShape("prefill_32k", 512, 4, "prefill")):
        whole = dryrun.step_counts(cfg, shape, one, False)
        card = dryrun.step_counts(cfg, shape, LOGICAL, False)
        assert card["flops"] * 4 == whole["flops"]
        assert whole["coll_count"] == 0 and card["coll_count"] > 0
        _, specs = make_specs(cfg, shape, LOGICAL, multi_pod=False)
        with fake_mesh(MESH, AXES) as mesh:
            local = distribute(specs.args, specs.pspecs, mesh)
            got = sum(roofline.tensor_bytes(t.to_local())
                      for t in roofline._tensors(local))
        assert got == dryrun.argument_bytes(specs, LOGICAL)


# ---------------------------------------------------------------------------
# (e) the fake group leaves
# ---------------------------------------------------------------------------

def test_fake_group_is_destroyed(monkeypatch):
    cfg = get_config("llama3-8b", smoke=True)
    dryrun.step_counts(cfg, _shape("decode"), LOGICAL, False)
    assert not dist.is_initialized() and sharding.get_rules() is None

    def fail(step, args):
        raise ValueError("a step that raises")
    monkeypatch.setattr(dryrun, "count_step", fail)
    with pytest.raises(ValueError, match="raises"):
        dryrun.step_counts(cfg, _shape("decode"), LOGICAL, False)
    assert not dist.is_initialized() and sharding.get_rules() is None
    with fake_mesh(MESH, AXES):
        with pytest.raises(RuntimeError, match="already exists"):
            with fake_mesh(MESH, AXES):
                pass
    assert not dist.is_initialized()


# ---------------------------------------------------------------------------
# (f) the calibration
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["llama3-8b", "kimi-k2-1t-a32b"])
def test_calibrated_collectives_equal_full_depth(arch, monkeypatch):
    # both depths calibrate from the same shallow steps: count each once
    seen, count = {}, dryrun.step_counts

    def once(cfg, shape, mesh, multi_pod):
        key = (cfg, shape, repr(mesh), multi_pod)
        if key not in seen:
            seen[key] = count(cfg, shape, mesh, multi_pod)
        return seen[key]
    monkeypatch.setattr(dryrun, "step_counts", once)
    base = get_config(arch, smoke=True)
    for depth in (3, 4):
        cfg = dataclasses.replace(base, n_layers=depth)
        for kind in ("decode", "train"):
            full = dryrun.step_counts(cfg, _shape(kind), LOGICAL, False)
            cal = dryrun.calibrated_counts(cfg, _shape(kind), LOGICAL,
                                           False)
            for key in COLLECTIVE_KINDS + ("coll_count", "flops", "bytes"):
                assert cal[key] == full[key], (depth, kind, key)
            assert full["coll_count"] > 0


# ---------------------------------------------------------------------------
# (a) single ops
# ---------------------------------------------------------------------------

def test_single_ops_equal_jax(jax_ref):
    P = sharding.P
    rules = {"batch": ("data",), "experts": "model", "model": "model",
             "vocab": "model", "seq": None}
    with fake_mesh(MESH, AXES) as mesh:
        sharding.set_rules(rules, mesh)
        try:
            h = distribute(_meta(ROW_H), P("data", "model"), mesh)
            w = distribute(_meta(ROW_W), P("model", None), mesh)
            row = _count(lambda: sharding.maybe_shard(h @ w, "batch",
                                                      None))
            cfg = get_config(MOE_ARCH, smoke=True)
            e, d, f, k = cfg.n_experts, cfg.d_model, cfg.d_ff, cfg.top_k
            tok = P("data", None)
            xt = distribute(_meta((MOE_T, d)), tok, mesh)
            pr = distribute(_meta((MOE_T, e)), tok, mesh)
            gw = distribute(_meta((MOE_T, k)), tok, mesh)
            gi = distribute(_meta((MOE_T, k), torch.int64), tok, mesh)
            ex = P("model", None, None)
            p = {"w_gate": distribute(_meta((e, d, f)), ex, mesh),
                 "w_up": distribute(_meta((e, d, f)), ex, mesh),
                 "w_down": distribute(_meta((e, f, d)), ex, mesh)}
            with roofline.CollectiveCounter() as cc:
                ep_moe(p, cfg, xt, pr, gw, gi)
            moe_ops = cc.ops
            table = distribute(_meta(EMB_TABLE), P("model", None), mesh)
            ids = distribute(_meta(EMB_IDS, torch.int32), P("data", None),
                             mesh)
            emb = _count(lambda: sharding.maybe_shard(
                embed(table, ids), "batch", None, None))
        finally:
            sharding.set_rules(None)
    ref = jax_ref()
    assert row == ref["row"]
    assert row == {**dict.fromkeys(COLLECTIVE_KINDS, 0),
                   "all-reduce": 4 * 16 * 4, "count": 1}
    # the router's statistics (its mean and the expert counts, [E] fp32
    # each, summed over the data axis: JAX takes them outside its
    # shard_map), then the dispatch's one all-reduce of the partial
    assert moe_ops[:2] == [("all-reduce", e * 4)] * 2
    moe_c = {**dict.fromkeys(COLLECTIVE_KINDS, 0), "count": 1,
             moe_ops[2][0]: moe_ops[2][1]}
    assert len(moe_ops) == 3 and moe_c == ref["moe"]
    assert moe_c["all-reduce"] == MOE_T // 2 * d * 4
    print(f"embedding lookup: port {emb}, JAX {ref['embed']}")


# ---------------------------------------------------------------------------
# (b) whole steps per family
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_step_collectives_near_jax(arch, kind, jax_ref):
    got = _port(dryrun.step_counts(get_config(arch, smoke=True),
                                   _shape(kind), LOGICAL, False))
    want = jax_ref()[f"{arch}/{kind}"]
    port_b = sum(got[k] for k in COLLECTIVE_KINDS)
    jax_b = sum(want[k] for k in COLLECTIVE_KINDS)
    ratio = port_b / jax_b
    print(f"{arch} {kind}: port {got}, JAX {want}, ratio {ratio:.4f}")
    if (arch, kind) in DEPARTURES:
        assert ratio == pytest.approx(DEPARTURES[arch, kind], rel=RATIO_TOL)
    else:
        assert BAND[0] <= ratio <= BAND[1]


@pytest.mark.parametrize("kind,mesh", [("decode", MESH), ("prefill", MESH),
                                       ("decode", (1, 4))])
def test_ssm_core_moves_no_all_gather(kind, mesh):
    """Where the model axis divides the smoke heads (8 of them), the
    partitioned mamba2 serving step moves each card's missing columns by
    all-to-all, five a layer (the projection, the conv state and its two
    weights, the new conv state back), and gathers nothing."""
    kinds = [k for k, _ in _fake_ops("mamba2-780m", kind, mesh)]
    assert "all-gather" not in kinds
    assert kinds.count("all-to-all") == \
        5 * get_config("mamba2-780m", smoke=True).n_layers


if __name__ == "__main__":
    _jax_reference(sys.argv[1], sys.argv[2].split(","))
