"""Training losses and gradients of every model family against the JAX
package's.

On the CPU in fp32 with TF32 off, from JAX-drawn smoke weights bridged
over (norm weights moved off zero by numpy draws) and the JAX package's
own training batches (``make_train_batch``, 2 x 80 tokens: longer than
gemma3's 64-token window):

  * ``loss`` and the gradient of every parameter leaf (the port by
    autograd through ``torch.utils.checkpoint``, JAX by ``jit(value_and_
    grad(model.loss))`` through ``jax.checkpoint``) for llama3-8b,
    qwen3-32b (qk-norm), gemma3-27b (windows), deepseek-v2-236b (MLA +
    MoE, in capacity mode at capacity factor 0.5, so that pairs drop at
    this size, and ``exact_moe``), kimi-k2-1t-a32b (MoE +
    GQA), mamba2-780m (SSM), hymba-1.5b (hybrid), whisper-base
    (encoder-decoder), and qwen2-vl-72b (M-RoPE) on the
    ``{'embeddings', 'labels'}`` batch form. The loss within ``LOSS_TOL``;
    each gradient element within ``GRAD_RTOL`` of itself plus
    ``GRAD_ATOL`` of its leaf's largest element (the two frameworks sum
    in different orders: measured <= 2e-5 of the leaf's largest);
  * capacity mode drops pairs there (its loss differs from
    ``exact_moe``'s by the JAX package's difference), so the capacity
    case is not the exact one again;
  * ``remat`` changes no bit of the loss or the gradients (the MoE
    routing's host sync is repeated in the recomputation), with
    deterministic algorithms on (the CPU's accumulating index backward
    of the embedding is not, run to run);
  * ``blocked_gqa_attend``'s gradients against the JAX package's blocked
    version at small blocks with a window and padded queries;
  * fp32 master weights are cast at every use: a bf16 model's training
    logits from fp32 masters equal, bit for bit, those from the same
    weights stored in bf16 (the leaves the reference reads in fp32 stay
    fp32 in both).
"""
import dataclasses
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import attention as jattn
from repro.models import build_model as jax_build_model
from repro_torch.configs import get_config
from repro_torch.models import attention as tattn
from repro_torch.models.api import build_model, param_shapes
from repro_torch.models.bridge import params_from_numpy
from repro_torch.models.transformer import FP32_KEYS, draw_params
from repro_torch.training.data import make_train_batch
from repro_torch.training.tree import flatten, unflatten
from test_torch_moe import _perturb_norms

B, S = 2, 80
# fp32 losses ~6.6 of the two frameworks: measured <= 1e-6 apart
LOSS_TOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-3, 1e-4

# (arch, exact_moe, config overrides): capacity factor 1.25 drops nothing
# at 160 tokens over 4 experts, 0.5 keeps 41 pairs of ~80 an expert
CAPACITY = ("deepseek-v2-236b", False, (("capacity_factor", 0.5),))
EXACT = ("deepseek-v2-236b", True, ())
FAMILIES = {"llama3-8b": ("llama3-8b", False, ()),
            "qwen3-32b": ("qwen3-32b", False, ()),
            "gemma3-27b": ("gemma3-27b", False, ()),
            "deepseek-v2-capacity": CAPACITY, "deepseek-v2-exact": EXACT,
            "kimi-k2": ("kimi-k2-1t-a32b", False, ()),
            "mamba2-780m": ("mamba2-780m", False, ()),
            "hymba-1.5b": ("hymba-1.5b", False, ()),
            "whisper-base": ("whisper-base", False, ()),
            "qwen2-vl-72b-embeddings": ("qwen2-vl-72b", False, ())}


@pytest.fixture(scope="module", autouse=True)
def _no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _batch(cfg):
    """The JAX package's training batch of step 3; qwen2-vl's as
    embeddings and labels (its frontend's form)."""
    batch = make_train_batch(cfg, B, S, 3)
    if cfg.mrope_sections:
        tokens = batch["tokens"]
        emb = np.random.default_rng(5).standard_normal(
            (B, S, cfg.d_model)).astype(np.float32)
        return {"embeddings": emb, "labels": tokens[:, 1:]}
    return batch


@functools.lru_cache(maxsize=None)
def _setup(arch, exact, over):
    cfg = dataclasses.replace(get_config(arch, smoke=True), **dict(over))
    jmodel = jax_build_model(dataclasses.replace(
        jax_get_config(arch, smoke=True), **dict(over)), exact_moe=exact)
    tree = _perturb_norms(jax.tree.map(np.asarray, jmodel.init_params(
        jax.random.PRNGKey(0))), np.random.default_rng(1))
    batch = _batch(cfg)
    jloss, jgrads = jax.jit(jax.value_and_grad(jmodel.loss))(
        jax.tree.map(jnp.asarray, tree),
        {k: jnp.asarray(v) for k, v in batch.items()})
    return types.SimpleNamespace(
        cfg=cfg, tree=tree, batch=batch, jloss=float(jloss),
        jgrads={k: np.asarray(v) for k, v in flatten(jgrads).items()})


def _loss_and_grads(arch, exact, over, remat=True):
    """The port's loss and gradients on the bridged weights (zeros for a
    leaf the loss does not use, as JAX gives)."""
    s = _setup(arch, exact, over)
    params = params_from_numpy(s.tree, s.cfg, device="cpu")
    model = build_model(s.cfg, params, device="cpu", exact_moe=exact,
                        remat=remat)
    leaves = {k: v.detach().requires_grad_()
              for k, v in flatten(params).items()}
    loss = model.loss(unflatten(leaves),
                      {k: torch.from_numpy(v) for k, v in s.batch.items()})
    grads = torch.autograd.grad(loss, list(leaves.values()),
                                allow_unused=True, materialize_grads=True)
    return loss.detach(), dict(zip(leaves, grads))


@pytest.mark.parametrize("family", FAMILIES)
def test_loss_and_every_gradient_leaf_match_jax(family):
    s = _setup(*FAMILIES[family])
    loss, grads = _loss_and_grads(*FAMILIES[family])
    assert abs(float(loss) - s.jloss) <= LOSS_TOL, (float(loss), s.jloss)
    assert set(grads) == set(s.jgrads)
    for k, g in grads.items():
        want = s.jgrads[k]
        np.testing.assert_allclose(
            g.numpy(), want, rtol=GRAD_RTOL,
            atol=GRAD_ATOL * np.abs(want).max(), err_msg=k)
        # every leaf takes part, but the embedding of an embeddings batch
        assert (np.abs(want).max() > 0) == (
            k != "embed" or "tokens" in s.batch), k


def test_capacity_mode_drops_pairs():
    """Capacity mode's loss differs from exact_moe's, in both packages,
    by the same amount: pairs were dropped, and the same ones."""
    cap, exact = _setup(*CAPACITY), _setup(*EXACT)
    got = [float(_loss_and_grads(*f)[0]) for f in (CAPACITY, EXACT)]
    assert abs(cap.jloss - exact.jloss) > 10 * LOSS_TOL
    assert abs((got[0] - got[1]) - (cap.jloss - exact.jloss)) <= LOSS_TOL


@pytest.mark.parametrize("family", ["llama3-8b", "deepseek-v2-capacity",
                                    "mamba2-780m", "whisper-base"])
def test_remat_changes_no_bit(family):
    torch.use_deterministic_algorithms(True)
    try:
        loss, grads = _loss_and_grads(*FAMILIES[family], remat=True)
        loss0, grads0 = _loss_and_grads(*FAMILIES[family], remat=False)
    finally:
        torch.use_deterministic_algorithms(False)
    assert torch.equal(loss, loss0)
    for k, g in grads.items():
        assert torch.equal(g, grads0[k]), k


def test_blocked_attention_gradients_match_jax():
    """q [2, 37, 4, 16], k/v [2, 37, 2, 16], blocks of 8 queries x 16
    keys (both padded), window 12, the last 3 queries of row 1 padding
    (position -1): gradients of a weighted sum of the output."""
    rng = np.random.default_rng(0)
    b, s, h, kvh, d, window = 2, 37, 4, 2, 16, 12
    q = rng.standard_normal((b, s, h, d)).astype(np.float32)
    k = rng.standard_normal((b, s, kvh, d)).astype(np.float32)
    v = rng.standard_normal((b, s, kvh, d)).astype(np.float32)
    w = rng.standard_normal((b, s, h, d)).astype(np.float32)
    pos = np.tile(np.arange(s, dtype=np.int32), (b, 1))
    pos[1, -3:] = -1

    def jloss(q, k, v):
        out = jattn.blocked_gqa_attend(q, k, v, jnp.asarray(pos),
                                       jnp.asarray(pos), window, d ** -0.5,
                                       block_q=8, block_k=16)
        return jnp.sum(out * w)

    want = jax.grad(jloss, argnums=(0, 1, 2))(q, k, v)
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    tp = torch.from_numpy(pos)
    out = tattn.blocked_gqa_attend(*ts, tp, tp, window, d ** -0.5,
                                   block_q=8, block_k=16)
    got = torch.autograd.grad((out * torch.from_numpy(w)).sum(), ts)
    for g, jg in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-4,
                                   atol=1e-5)


# leaves the JAX package reads in fp32 whatever the compute dtype: the
# norms and SSM constants (FP32_KEYS), and MLA's absorbed up-projections
READ_FP32 = FP32_KEYS | {"w_uk", "w_uv"}


def _train_logits(model, params, batch):
    if model.cfg.enc_dec:
        enc_out = model.encode(params, batch["enc_emb"], train=True)
        return model.forward(params, batch["tokens"], None, None,
                             enc_out=enc_out, train=True)[0]
    return model.forward(params, batch["tokens"], None, None,
                         train=True)[0]


@pytest.mark.parametrize("arch", [
    "llama3-8b", "qwen3-32b", "gemma3-27b", "deepseek-v2-236b",
    "kimi-k2-1t-a32b", "mamba2-780m", "hymba-1.5b", "whisper-base"])
def test_fp32_masters_are_cast_at_every_use(arch):
    cfg = dataclasses.replace(get_config(arch, smoke=True),
                              dtype="bfloat16")
    gen = torch.Generator().manual_seed(0)
    master = draw_params(param_shapes(cfg), torch.float32, generator=gen,
                         device="cpu")
    stored = unflatten({k: v if k.rsplit("/", 1)[-1] in READ_FP32
                        else v.to(torch.bfloat16)
                        for k, v in flatten(master).items()})
    model = build_model(cfg, stored, device="cpu", exact_moe=True)
    batch = {k: torch.from_numpy(v) for k, v in
             make_train_batch(cfg, B, 24, 0).items()}
    with torch.no_grad():
        got = _train_logits(model, master, batch)
        want = _train_logits(model, stored, batch)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, want)
