"""Expert-parallel MoE over a ``torch.distributed`` mesh against the JAX
package's ``shard_map`` dispatch, on a 2x2 ``("data", "model")`` mesh on
the CPU, in fp32.

The same inputs (numpy seeds) and weights (JAX's ``init_params`` of the
smoke kimi-k2-1t-a32b and deepseek-v2-236b, norms moved off zero) go
through both:

* JAX: this file run as a script (``python
  tests/test_torch_expert_parallel.py IN.npz OUT.npz mesh``) with four
  host devices, the models under ``sharding.set_rules`` and ``with
  mesh`` (the test session's JAX sees one device, so it runs in a
  subprocess); and again with ``true`` for the true gradients (below);
* the port: four gloo ranks (``torch.multiprocessing``, spawn), each with
  its data block of tokens and, through the bridge and
  ``shard_experts``, its two of the four experts.

Both run at once, once per module. Cases:

(a) the MoE block on ``x (4, 8, d)``, top-2 of 4 experts: at capacity
    factor 8 (nothing drops) against JAX's output and the dense oracle,
    and at 0.5 (pairs drop) against JAX's; ``aux`` within ``AUX_TOL``;
(b) the fallback: a global ``t`` that does not split over the two data
    ranks (3 tokens as 2 + 1, and 17 as 9 + 8 at factor 0.5, where pairs
    drop under the global capacity) against JAX's GSPMD branch;
(c) both models' training logits and ``loss`` under the mesh against
    JAX's jitted ``loss`` under the same rules;
(d) gradients: every rank's leaf gradients summed over the data axis
    equal the true gradient (the routed experts: its slice of the
    experts), and the block's input gradients each rank's rows of it;
(e) a 1x1 mesh (world size 1) gives what no mesh gives, bit for bit;
    ``exact`` mode under the 2x2 mesh gives the dense oracle's output;
(f) the fallback in bf16 (the partials summed in bf16, as JAX's psum) against
    the port's one process.

JAX's ``jax.grad`` through its ``shard_map`` dispatch is wrong for the
tokens and the router (its expert-weight gradients are right), and so
for every leaf upstream of an MoE layer: a central difference of JAX's
own mesh function, along one token's row and along the router, agrees
with the port and with JAX's no-mesh gradient of the same function, not
with JAX's mesh gradient (``test_jax_mesh_gradient_fails_a_central_
difference``). The true gradients come from JAX with no mesh installed:
the block's loss as one call per data block (the shard_map branch's
capacity; its output is held to JAX's mesh output) plus the whole
batch's aux, and the models at the capacity factor ``E / k``, where
nothing drops and the mesh's function is the one-device one. Every leaf
is held to those; the routed experts also to JAX's mesh gradient.
"""
import dataclasses
import os
import subprocess
import sys
import time
from pathlib import Path

if __name__ == "__main__":      # the JAX reference: four host devices
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count=4")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402
import torch.multiprocessing as mp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.models import sharding as jax_sharding  # noqa: E402
from repro.models.moe import moe_block as jax_moe_block  # noqa: E402
from repro.models.moe import moe_block_dense_ref  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch.mesh import init_gloo, process_mesh  # noqa: E402
from repro_torch.models import moe, sharding  # noqa: E402
from repro_torch.models.bridge import params_from_numpy  # noqa: E402
from repro_torch.models.transformer import (DecoderModel,  # noqa: E402
                                            layer_slice)
from repro_torch.training.tree import flatten, unflatten  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
ARCHS = ("kimi-k2-1t-a32b", "deepseek-v2-236b")
MESH, AXES = (2, 2), ("data", "model")
RULES = {"batch": ("data",), "experts": "model", "model": "model"}
# case -> (capacity factor, input rows, seq): (4, 8) splits as 2 + 2
# rows over the data axis (the shard_map branch), 3 and 17 unevenly
# (GSPMD's); at 17 tokens a factor of 0.5 gives a capacity of 8 of
# ~8.5 pairs an expert
BLOCK_CASES = {"nodrop": (8.0, 4, 8), "drop": (0.5, 4, 8),
               "fallback3": (1.25, 3, 1), "fallback17": (0.5, 17, 1)}
TOKENS = (4, 17)                # the models' batch: 4 rows of 16 + 1
AUX_W = 0.5                     # the aux's weight in the block's loss
OUT_TOL, AUX_TOL = 1e-5, 1e-6
LOGIT_TOL, LOSS_TOL = 1e-4, 1e-5
GRAD_TOL = 1e-4                 # of the leaf's largest magnitude
# the central differences of JAX's mesh function: cases, step, and the
# tolerance relative to max(1, |derivative|) (fp32 rounding at this step
# moves them by <= 1e-3; JAX's mesh gradient misses by > 0.3)
FD_CASES, FD_EPS, FD_TOL = ("nodrop", "drop"), 1e-2, 5e-3
# (f): bf16 against one process, of the largest magnitude (each expert
# rank's partial rounds to bf16 before the sum: ~2^-8 of it)
BF16_CASE, BF16_TOL = "fallback17", 2.0 ** -7
JAX_TIMEOUT = 300


def _blocks(n):
    """Row bounds of the data axis's blocks of ``n`` rows (the first
    takes the odd row)."""
    cut = (n + 1) // 2
    return [(0, cut), (cut, n)]


def _sub(flat, prefix):
    return {k[len(prefix):]: v for k, v in flat.items()
            if k.startswith(prefix)}


def _make_inputs(path):
    """Weights, block inputs and token batches as one ``.npz``, and the
    dense oracle of the no-drop case (one device, in this process)."""
    from test_torch_moe import _perturb_norms    # norms moved off zero
    data, dense = {}, {}
    rng = np.random.default_rng(0)
    for arch in ARCHS:
        jm = jax_build_model(jax_get_config(arch, smoke=True))
        tree = _perturb_norms(jax.tree.map(np.asarray, jm.init_params(
            jax.random.PRNGKey(0))), np.random.default_rng(1))
        for k, v in flatten(tree).items():
            data[f"{arch}/params/{k}"] = v
        d = jm.cfg.d_model
        for case, (_, b, s) in BLOCK_CASES.items():
            data[f"{arch}/{case}/x"] = rng.standard_normal(
                (b, s, d)).astype(np.float32)
            data[f"{arch}/{case}/r"] = rng.standard_normal(
                (b, s, d)).astype(np.float32)
        data[f"{arch}/tokens"] = rng.integers(
            0, jm.cfg.vocab_size, TOKENS).astype(np.int32)
        vrng = np.random.default_rng(7)
        for case in FD_CASES:       # unit directions: a token's row, router
            _, b, s = BLOCK_CASES[case]
            vx = np.zeros((b, s, d), np.float32)
            vx[1, 3] = vrng.standard_normal(d)
            vr = vrng.standard_normal((d, jm.cfg.n_experts)).astype(
                np.float32)
            data[f"{arch}/{case}/vx"] = vx / np.linalg.norm(vx)
            data[f"{arch}/{case}/vr"] = vr / np.linalg.norm(vr)
        p = jax.tree.map(lambda a: jnp.asarray(a[0]), tree["layers"]["moe"])
        cfg = dataclasses.replace(jm.cfg, capacity_factor=8.0)
        dense[arch] = np.asarray(moe_block_dense_ref(
            p, cfg, jnp.asarray(data[f"{arch}/nodrop/x"])))
    np.savez(path, **data)
    return data, dense


# ---------------------------------------------------------------------------
# the JAX reference (this file as a script)
# ---------------------------------------------------------------------------

def _block_loss(c, blocks):
    """JAX: the block's loss ``sum(out * r) + AUX_W * aux``; with
    ``blocks``, ``out`` is the outputs of each block's own call (the
    shard_map branch's capacity) and the aux that of the whole batch."""
    def f(p, x, r):
        o, aux = jax_moe_block(p, c, x, exact=False)
        if blocks is not None:
            o = jnp.concatenate([jax_moe_block(p, c, x[lo:hi],
                                               exact=False)[0]
                                 for lo, hi in blocks])
        return jnp.sum(o * r) + AUX_W * aux, (o, aux)
    return jax.jit(jax.value_and_grad(f, argnums=(0, 1), has_aux=True))


def _jax_reference(inputs, out, mode):
    """``mode`` "mesh": JAX's results under the 2x2 mesh, and central
    differences of its block's loss for ``FD_CASES``; "true": the true
    gradients, from the same functions with no mesh installed (the
    shard_map branch's per-block capacity from a call per block; the
    model at its no-drop capacity factor, where the two agree)."""
    data = dict(np.load(inputs))
    mesh = jax.sharding.Mesh(np.array(jax.devices()).reshape(MESH), AXES)
    res = {}

    def under_mesh(fn, *args):
        if mode == "true":
            return fn(*args)
        jax_sharding.set_rules(RULES, mesh)
        try:
            with mesh:
                return fn(*args)
        finally:
            jax_sharding.set_rules(None)

    for arch in ARCHS:
        cfg = jax_get_config(arch, smoke=True)
        params = jax.tree.map(jnp.asarray,
                              unflatten(_sub(data, f"{arch}/params/")))
        p = jax.tree.map(lambda a: a[0], params["layers"]["moe"])
        tokens = jnp.asarray(data[f"{arch}/tokens"])
        for case, (cf, b, _) in BLOCK_CASES.items():
            c = dataclasses.replace(cfg, capacity_factor=cf)
            blocks = _blocks(b) if mode == "true" and b == 4 else None
            fn = _block_loss(c, blocks)
            x, r = data[f"{arch}/{case}/x"], data[f"{arch}/{case}/r"]
            (_, (o, aux)), (gp, gx) = under_mesh(fn, p, x, r)
            tag = f"{arch}/{case}/{'true' if mode == 'true' else 'jax'}"
            res.update({f"{tag}/{k}": v for k, v in flatten(gp).items()})
            res.update({f"{tag}/x": gx, f"{tag}/out": o, f"{tag}/aux": aux})
            if mode == "mesh" and case in FD_CASES:
                vx, vr = data[f"{arch}/{case}/vx"], data[f"{arch}/{case}/vr"]

                def value(step, name):
                    q = dict(p, router=p["router"] + step * vr) \
                        if name == "router" else p
                    xx = x + step * vx if name == "x" else x
                    return float(under_mesh(fn, q, xx, r)[0][0])
                for name in ("x", "router"):
                    res[f"{arch}/{case}/fd/{name}"] = (
                        value(FD_EPS, name) - value(-FD_EPS, name)) \
                        / (2 * FD_EPS)
        if mode == "true":
            free = jax_build_model(dataclasses.replace(
                cfg, capacity_factor=cfg.n_experts / cfg.top_k))
            g = jax.jit(jax.grad(lambda q, t: free.loss(q, {"tokens": t})))(
                params, tokens)
            res.update({f"{arch}/free/true/{k}": v
                        for k, v in flatten(g).items()})
            continue
        model = jax_build_model(cfg)
        loss, g = under_mesh(jax.jit(jax.value_and_grad(
            lambda q, t: model.loss(q, {"tokens": t}))), params, tokens)
        logits = under_mesh(jax.jit(lambda q, t: model.forward(
            q, t, None, jnp.zeros((t.shape[0],), jnp.int32),
            train=True)[0]), params, tokens[:, :-1])
        res.update({f"{arch}/loss": loss, f"{arch}/logits": logits})
        res.update({f"{arch}/model/jax/{k}": v
                    for k, v in flatten(g).items()})
    np.savez(out, **{k: np.asarray(v) for k, v in res.items()})


# ---------------------------------------------------------------------------
# the port: one process per rank
# ---------------------------------------------------------------------------

def _with_grad(tree):
    """Flat leaves of ``tree``, detached copies that require grad."""
    return {k: v.detach().clone().requires_grad_()
            for k, v in flatten(tree).items()}


def _model_grads(model, params, tokens):
    leaves = _with_grad(params)
    loss = model.loss(unflatten(leaves), {"tokens": tokens})
    grads = torch.autograd.grad(loss, list(leaves.values()),
                                allow_unused=True, materialize_grads=True)
    return loss, dict(zip(leaves, grads))


def _rank(rank, inputs, outdir, store):
    """One rank of the 2x2 mesh: every case on its data block and its
    experts, results to ``rank{rank}.npz``."""
    torch.set_num_threads(1)
    init_gloo(f"file://{store}", rank, MESH[0] * MESH[1])
    try:
        mesh = process_mesh(MESH, AXES, "cpu")
        i = mesh.get_local_rank("data")
        data = dict(np.load(inputs))
        res = {}
        sharding.set_rules(RULES, mesh)
        for arch in ARCHS:
            cfg = get_config(arch, smoke=True)
            tree = unflatten(_sub(data, f"{arch}/params/"))
            params = sharding.shard_experts(
                params_from_numpy(tree, cfg, device="cpu"), mesh, RULES)
            p = layer_slice(params["layers"]["moe"], 0)
            for case, (cf, b, _) in BLOCK_CASES.items():
                lo, hi = _blocks(b)[i]
                c = dataclasses.replace(cfg, capacity_factor=cf)
                leaves = _with_grad(p)
                x = torch.from_numpy(
                    data[f"{arch}/{case}/x"][lo:hi]).requires_grad_()
                o, aux = moe.moe_block(unflatten(leaves), c, x)
                # this rank's terms of the global loss: the gradient of
                # the sum over ranks is the sum of their gradients
                r = torch.from_numpy(data[f"{arch}/{case}/r"][lo:hi])
                grads = torch.autograd.grad(
                    (o * r).sum() + AUX_W * aux, [x, *leaves.values()])
                tag = f"{arch}/{case}/port"
                res.update({f"{tag}/out": o.detach(), f"{tag}/aux": aux,
                            f"{tag}/x": grads[0]})
                res.update({f"{tag}/{k}": g
                            for k, g in zip(leaves, grads[1:])})
            lo, hi = _blocks(4)[i]
            x = torch.from_numpy(data[f"{arch}/nodrop/x"][lo:hi])
            res[f"{arch}/exact/port/out"] = moe.moe_block(p, cfg, x,
                                                          exact=True)[0]
            cf, b, _ = BLOCK_CASES[BF16_CASE]
            lo, hi = _blocks(b)[i]
            p16 = layer_slice(sharding.shard_experts(params_from_numpy(
                tree, cfg, device="cpu", dtype=torch.bfloat16), mesh,
                RULES)["layers"]["moe"], 0)
            x16 = torch.from_numpy(data[f"{arch}/{BF16_CASE}/x"][lo:hi])
            res[f"{arch}/bf16/port/out"] = moe.moe_block(
                p16, dataclasses.replace(cfg, capacity_factor=cf),
                x16.to(torch.bfloat16))[0].float()
            lo, hi = _blocks(TOKENS[0])[i]
            tokens = torch.from_numpy(data[f"{arch}/tokens"][lo:hi])
            model = DecoderModel(cfg, params, device="cpu")
            loss, grads = _model_grads(model, params, tokens)
            with torch.no_grad():
                logits = model.forward(params, tokens[:, :-1], None, None,
                                       train=True)[0]
            res.update({f"{arch}/port/loss": loss,
                        f"{arch}/port/logits": logits})
            res.update({f"{arch}/model/port/{k}": g
                        for k, g in grads.items()})
            free = DecoderModel(dataclasses.replace(
                cfg, capacity_factor=cfg.n_experts / cfg.top_k), params,
                device="cpu")
            res.update({f"{arch}/free/port/{k}": g for k, g in
                        _model_grads(free, params, tokens)[1].items()})
        np.savez(Path(outdir) / f"rank{rank}.npz",
                 **{k: v.detach().numpy() for k, v in res.items()})
    finally:
        sharding.set_rules(None)
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX reference in a subprocess and the four ranks, at once:
    (inputs, dense oracle, JAX's results, each rank's results)."""
    tmp = tmp_path_factory.mktemp("ep")
    data, dense = _make_inputs(tmp / "inputs.npz")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), str(ROOT / "tests"),
         os.environ.get("PYTHONPATH", "")]))
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, __file__, str(tmp / "inputs.npz"),
         str(tmp / f"{mode}.npz"), mode], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for mode in ("mesh", "true")]
    try:
        mp.start_processes(_rank, args=(str(tmp / "inputs.npz"), str(tmp),
                                        str(tmp / "store")),
                           nprocs=MESH[0] * MESH[1], join=True,
                           start_method="spawn")
        t_ranks = time.perf_counter() - t0
        logs = [proc.communicate(timeout=JAX_TIMEOUT)[0] for proc in procs]
    finally:
        for proc in procs:
            proc.kill()
    for proc, log in zip(procs, logs):
        assert proc.returncode == 0, log
    print(f"4 ranks in {t_ranks:.1f} s, JAX reference in "
          f"{time.perf_counter() - t0:.1f} s")
    ranks = [dict(np.load(tmp / f"rank{r}.npz")) for r in range(4)]
    jres = {**np.load(tmp / "mesh.npz"), **np.load(tmp / "true.npz")}
    return data, dense, jres, ranks


def _rank_of(i, j):
    return i * MESH[1] + j


def _rows(ranks, key, j):
    """The data axis's blocks of ``key`` at expert coordinate ``j``,
    stacked in order."""
    return np.concatenate([ranks[_rank_of(i, j)][key]
                           for i in range(MESH[0])])


def _routed(key):
    """Whether ``key`` is a routed-expert leaf (of the block, or under a
    model's ``moe``)."""
    parts = key.split("/")
    return parts[-1] in moe.EXPERT_KEYS and parts[:-1][-1:] in ([], ["moe"])


def _check_grads(ranks, port, want, routed_only=False):
    """Every leaf's gradient under ``port`` summed over the data axis
    against ``want``'s (the routed experts against the slice of this
    expert coordinate), at each expert coordinate; ``routed_only``: the
    routed experts' leaves alone."""
    keys = [k for k in want if not routed_only or _routed(k)]
    assert keys
    for k in keys:
        w = want[k]
        assert np.abs(w).max() > 0, k
        for j in range(MESH[1]):
            got = sum(ranks[_rank_of(i, j)][f"{port}/{k}"]
                      for i in range(MESH[0]))
            w_j = w
            if _routed(k):
                e_loc = got.shape[-3]
                w_j = w[..., j * e_loc:(j + 1) * e_loc, :, :]
            np.testing.assert_allclose(
                got, w_j, rtol=0, atol=GRAD_TOL * np.abs(w).max(),
                err_msg=f"{k} at expert coordinate {j}")


def _check_block(jres, ranks, tag):
    """Output and aux against JAX's under the mesh, the input gradient
    against the true one, on every rank; the no-mesh function the true
    gradients are taken of gives JAX's mesh output and aux."""
    np.testing.assert_allclose(jres[f"{tag}/true/out"],
                               jres[f"{tag}/jax/out"], rtol=0, atol=OUT_TOL)
    assert abs(float(jres[f"{tag}/true/aux"])
               - float(jres[f"{tag}/jax/aux"])) <= AUX_TOL
    for j in range(MESH[1]):
        np.testing.assert_allclose(_rows(ranks, f"{tag}/port/out", j),
                                   jres[f"{tag}/jax/out"], rtol=0,
                                   atol=OUT_TOL)
        want = jres[f"{tag}/true/x"]
        np.testing.assert_allclose(_rows(ranks, f"{tag}/port/x", j), want,
                                   rtol=0, atol=GRAD_TOL * np.abs(want).max())
    for r in ranks:
        assert abs(float(r[f"{tag}/port/aux"])
                   - float(jres[f"{tag}/jax/aux"])) <= AUX_TOL


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("case", ["nodrop", "drop"])
def test_block_matches_shard_map(runs, arch, case):
    """(a) The shard_map branch: output and aux on every rank equal JAX's
    and the input gradient the true one; without drops the output also
    equals the dense oracle, with drops pairs did drop under the local
    capacity."""
    data, dense, jres, ranks = runs
    tag = f"{arch}/{case}"
    _check_block(jres, ranks, tag)
    cfg = dataclasses.replace(get_config(arch, smoke=True),
                              capacity_factor=BLOCK_CASES[case][0])
    router = torch.from_numpy(
        data[f"{arch}/params/layers/moe/router"][0].copy())
    x = torch.from_numpy(data[f"{tag}/x"])
    dropped = 0
    for lo, hi in _blocks(x.shape[0]):
        xt = x[lo:hi].reshape(-1, cfg.d_model)
        _, _, idx = moe.route({"router": router}, cfg, xt)
        dropped += int(moe.dispatch(idx, cfg.n_experts, moe.capacity(
            xt.shape[0], cfg, False))[2])
    if case == "nodrop":
        assert dropped == 0
        for j in range(MESH[1]):
            np.testing.assert_allclose(_rows(ranks, f"{tag}/port/out", j),
                                       dense[arch], rtol=0, atol=OUT_TOL)
    else:
        assert dropped > 0


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("case", ["fallback3", "fallback17"])
def test_fallback_matches_gspmd_branch(runs, arch, case):
    """(b) Tokens that do not split over the data axis: the blocks
    gathered and the global capacity rule, against JAX's GSPMD branch
    (output, aux and input gradient on every rank)."""
    _, _, jres, ranks = runs
    tag = f"{arch}/{case}"
    _check_block(jres, ranks, tag)
    np.testing.assert_allclose(jres[f"{tag}/jax/x"], jres[f"{tag}/true/x"],
                               rtol=0, atol=GRAD_TOL * np.abs(
                                   jres[f"{tag}/true/x"]).max())


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("case", FD_CASES)
def test_jax_mesh_gradient_fails_a_central_difference(runs, arch, case):
    """Why the true gradients come from JAX with no mesh: along one
    token's row of ``x`` and along the router, a central difference of
    JAX's own function under the mesh agrees with the no-mesh gradient
    and with the port's (summed over the data axis), and not with JAX's
    ``jax.grad`` under the mesh."""
    data, _, jres, ranks = runs
    tag = f"{arch}/{case}"
    port = {"x": _rows(ranks, f"{tag}/port/x", 0),
            "router": sum(ranks[_rank_of(i, 0)][f"{tag}/port/router"]
                          for i in range(MESH[0]))}
    for name, v in (("x", data[f"{tag}/vx"]), ("router", data[f"{tag}/vr"])):
        fd = float(jres[f"{tag}/fd/{name}"])
        true = float(np.sum(jres[f"{tag}/true/{name}"] * v))
        tol = FD_TOL * max(1.0, abs(true))
        assert abs(fd - true) <= tol, (name, fd, true)
        assert abs(fd - float(np.sum(port[name] * v))) <= tol, name
        jax_mesh = float(np.sum(jres[f"{tag}/jax/{name}"] * v))
        assert abs(fd - jax_mesh) > tol, (name, fd, jax_mesh)


@pytest.mark.parametrize("arch", ARCHS)
def test_fallback_in_bf16_matches_one_process(runs, arch):
    """(f) GSPMD's branch in bf16 (9 + 8 tokens, pairs dropping): every
    rank's rows against the port's one process with every expert, within
    ``BF16_TOL`` of the largest magnitude."""
    data, _, _, ranks = runs
    cfg = dataclasses.replace(get_config(arch, smoke=True),
                              capacity_factor=BLOCK_CASES[BF16_CASE][0])
    params = params_from_numpy(unflatten(_sub(data, f"{arch}/params/")),
                               cfg, device="cpu", dtype=torch.bfloat16)
    x = torch.from_numpy(data[f"{arch}/{BF16_CASE}/x"]).to(torch.bfloat16)
    want = moe.moe_block(layer_slice(params["layers"]["moe"], 0), cfg,
                         x)[0].float().numpy()
    for j in range(MESH[1]):
        np.testing.assert_allclose(_rows(ranks, f"{arch}/bf16/port/out", j),
                                   want, rtol=0,
                                   atol=BF16_TOL * np.abs(want).max())


@pytest.mark.parametrize("arch", ARCHS)
def test_exact_mode_under_the_mesh_is_the_dense_oracle(runs, arch):
    """``exact`` under the mesh takes GSPMD's branch (every token kept,
    over the gathered blocks): the dense oracle's output."""
    _, dense, _, ranks = runs
    for j in range(MESH[1]):
        np.testing.assert_allclose(_rows(ranks, f"{arch}/exact/port/out",
                                         j), dense[arch], rtol=0,
                                   atol=OUT_TOL)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("case", list(BLOCK_CASES))
def test_block_gradients_match_jax(runs, arch, case):
    """(d) The block's weight gradients summed over the data axis: every
    leaf against the true gradient, the routed experts also against JAX's
    ``jax.grad`` under the mesh."""
    _, _, jres, ranks = runs
    tag = f"{arch}/{case}"
    def leaves(src):
        return {k: v for k, v in _sub(jres, f"{tag}/{src}/").items()
                if k not in ("x", "out", "aux")}
    _check_grads(ranks, f"{tag}/port", leaves("true"))
    _check_grads(ranks, f"{tag}/port", leaves("jax"), routed_only=True)


@pytest.mark.parametrize("arch", ARCHS)
def test_model_logits_and_loss_match_jax(runs, arch):
    """(c) Training logits (each rank its rows) and the global loss."""
    _, _, jres, ranks = runs
    for j in range(MESH[1]):
        np.testing.assert_allclose(_rows(ranks, f"{arch}/port/logits", j),
                                   jres[f"{arch}/logits"], rtol=0,
                                   atol=LOGIT_TOL)
    for r in ranks:
        assert abs(float(r[f"{arch}/port/loss"])
                   - float(jres[f"{arch}/loss"])) <= LOSS_TOL


@pytest.mark.parametrize("arch", ARCHS)
def test_model_gradients_match_jax(runs, arch):
    """(d) The model's routed-expert gradients against JAX's ``jax.grad``
    under the mesh; every leaf, at the capacity factor where nothing
    drops (so the mesh's function is the one-device one), against the
    true gradient."""
    _, _, jres, ranks = runs
    _check_grads(ranks, f"{arch}/model/port",
                 _sub(jres, f"{arch}/model/jax/"), routed_only=True)
    _check_grads(ranks, f"{arch}/free/port", _sub(jres, f"{arch}/free/true/"))


def test_one_rank_mesh_is_no_mesh(tmp_path):
    """(e) World size 1 on a 1x1 mesh: the block's output, aux and
    gradients and the model's loss equal, bit for bit, those with no
    mesh installed."""
    cfg = dataclasses.replace(get_config("deepseek-v2-236b", smoke=True),
                              capacity_factor=0.5)
    gen = torch.Generator().manual_seed(0)
    model = DecoderModel(cfg, device="cpu", generator=gen)
    p = layer_slice(model.params["layers"]["moe"], 0)
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal(
        (2, 16, cfg.d_model)).astype(np.float32))
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 17)))

    def run():
        leaves = _with_grad(p)
        o, aux = moe.moe_block(unflatten(leaves), cfg, x)
        grads = torch.autograd.grad(o.square().sum() + aux,
                                    list(leaves.values()))
        return [o, aux, *grads, model.loss(model.params,
                                           {"tokens": tokens})]
    want = run()
    init_gloo(f"file://{tmp_path / 'store'}", 0, 1)
    try:
        sharding.set_rules(RULES, process_mesh((1, 1), AXES, "cpu"))
        got = run()
    finally:
        sharding.set_rules(None)
        dist.destroy_process_group()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_shard_experts_refuses_an_uneven_split():
    """``E % n != 0`` raises (JAX's ``E // n`` would drop experts); a
    dense MLP's leaves are left whole."""
    class Mesh:
        def __getitem__(self, axis):
            return type("Axis", (), {"size": lambda self: 3})()

        def get_local_rank(self, axis):
            return 0
    cfg = get_config("deepseek-v2-236b", smoke=True)
    params = {"layers": {"moe": {"w_gate": torch.zeros(
        1, cfg.n_experts, 2, 2)}}}
    with pytest.raises(ValueError, match="do not split"):
        sharding.shard_experts(params, Mesh(), RULES)
    mlp = torch.zeros(1, 2, 2)
    out = sharding.shard_experts({"layers": {"mlp": {"w_gate": mlp}}},
                                 Mesh(), RULES)
    assert out["layers"]["mlp"]["w_gate"] is mlp


if __name__ == "__main__":
    _jax_reference(*sys.argv[1:4])
