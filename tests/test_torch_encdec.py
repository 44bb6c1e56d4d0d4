"""The encoder-decoder (whisper) of the port against the JAX package's.

On the CPU in fp32 with TF32 off, from numpy inputs and JAX-drawn weights
bridged over (norm weights moved off zero by numpy draws), at whisper's
smoke config (2 + 2 layers, 64 encoder frames):

  * the parameter layout; ``encode``, ``compute_cross_kv`` and the
    per-layer ``cross_kv``, and the serving ``forward`` on a prefill chunk
    that installs cross-KV from ``enc_out`` and a decode step that reads
    it from the cache: within 1e-4;
  * serving, mirroring ``tests/test_whisper_serving.py``: a Cronus pair
    whose PPI->CPI payload carries the cross-attention KV gives the
    logits of one executor's unsplit run (``tests/test_torch_moe.py``'s
    near-tie rule), and a payload whose cross-KV is zeroed does not;
  * the length check of ``enc_emb``, and the training entry points that
    wait for the training slice.
"""
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
from repro_torch.core.executor import RealExecutor
from repro_torch.core.request import Request
from repro_torch.models import attention as tattn
from repro_torch.models.api import build_model, param_shapes
from repro_torch.models.bridge import params_from_numpy
from repro_torch.models.encdec import EncDecModel
from repro_torch.models.transformer import layer_slice
from repro_torch.serving import hardware
from repro_torch.serving.api import slot_executor_factory
from repro_torch.serving.simulator import build_system
from test_torch_moe import _compare, _perturb_norms, _recording, _shapes

ARCH = "whisper-base"
S_KV, SLOTS, CHUNK, BLOCK = 128, 4, 16, 4
LENS = [(21, 4), (13, 4)]
TOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def _no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=tol, atol=tol)


@functools.lru_cache(maxsize=None)
def _setup():
    cfg = get_config(ARCH, smoke=True)
    jcfg = jax_get_config(ARCH, smoke=True)
    jmodel = jax_build_model(jcfg)
    tree = _perturb_norms(jax.tree.map(np.asarray, jmodel.init_params(
        jax.random.PRNGKey(0))), np.random.default_rng(1))
    model = build_model(cfg, params_from_numpy(tree, cfg, device="cpu"),
                        device="cpu")
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n, _ in LENS]
    encs = [rng.standard_normal((cfg.enc_seq_len, cfg.d_model)).astype(
        np.float32) for _ in LENS]
    return types.SimpleNamespace(
        cfg=cfg, jcfg=jcfg, jmodel=jmodel, tree=tree,
        jparams=jax.tree.map(jnp.asarray, tree), model=model,
        prompts=prompts, encs=encs,
        encode=jax.jit(jmodel.encode),
        forward=jax.jit(lambda *a: jmodel.forward(
            *a[:4], positions=a[4], kv_positions=a[5], enc_out=a[6])))


def test_param_layout_equals_jax():
    s = _setup()
    jtree = jax.eval_shape(s.jmodel.init_params, jax.random.PRNGKey(0))
    assert param_shapes(s.cfg) == _shapes(jtree)
    assert isinstance(s.model, EncDecModel)


def test_encode_and_cross_kv_match_jax():
    s = _setup()
    enc = np.stack(s.encs)
    with torch.no_grad():
        out = s.model.encode(s.model.params, torch.from_numpy(enc))
        ck, cv = s.model.compute_cross_kv(s.model.params, out)
        k0, v0 = tattn.cross_kv(layer_slice(s.model.params["layers"],
                                            0)["cross"], s.cfg, out)
    jout = s.encode(s.jparams, jnp.asarray(enc))
    _close(out, jout)
    jck, jcv = s.jmodel.compute_cross_kv(s.jparams, jout)
    _close(ck, jck)
    _close(cv, jcv)
    jk0, jv0 = jattn.cross_kv(jax.tree.map(lambda a: a[0],
                                           s.jparams["layers"])["cross"],
                              s.jcfg, jout)
    _close(k0, jk0)
    _close(v0, jv0)
    _close(k0, ck[0])


def test_forward_matches_jax():
    """A 16-token prefill chunk on two rows (the second padded after 11)
    with ``enc_out``, then a decode step that reads the cross-KV from the
    cache: logits and every cache leaf equal to JAX's."""
    s = _setup()
    rng = np.random.default_rng(4)
    b, c = 2, 16
    toks = rng.integers(0, s.cfg.vocab_size, (b, c)).astype(np.int32)
    positions = np.tile(np.arange(c, dtype=np.int32), (b, 1))
    positions[1, 11:] = -1
    kv_pos = np.full((b, S_KV), -1, np.int32)
    kv_pos[0, :c] = np.arange(c)
    kv_pos[1, :11] = np.arange(11)
    lens = np.zeros((b,), np.int32)
    enc = np.stack(s.encs)
    jenc = s.encode(s.jparams, jnp.asarray(enc))
    with torch.no_grad():
        tenc = s.model.encode(s.model.params, torch.from_numpy(enc))
    jcache, cache = s.jmodel.init_cache(b, S_KV), s.model.init_cache(b, S_KV)
    for step in range(2):
        jl, jcache, _ = s.forward(
            s.jparams, jnp.asarray(toks), jcache, jnp.asarray(lens),
            jnp.asarray(positions), jnp.asarray(kv_pos),
            jenc if step == 0 else None)
        with torch.no_grad():
            tl, cache, _ = s.model.forward(
                s.model.params, torch.from_numpy(toks), cache,
                torch.from_numpy(lens), positions=torch.from_numpy(positions),
                kv_positions=torch.from_numpy(kv_pos),
                enc_out=tenc if step == 0 else None, decode=step == 1)
        live = positions >= 0
        _close(tl.numpy()[live], np.asarray(jl)[live])
        for key in ("k", "v"):
            _close(cache["stack"][key], jcache["stack"][key])
        for key in ("cross_k", "cross_v"):
            _close(cache[key], jcache[key])
        if step == 0:            # then one decode step from 16 and 11
            lens = np.asarray([c, 11], np.int32)
            toks = rng.integers(0, s.cfg.vocab_size, (b, 1)).astype(np.int32)
            positions = lens[:, None].copy()
            kv_pos[0, c], kv_pos[1, 11] = c, 11


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def _oracle(s, i):
    """Request ``i`` on one executor: chunked prefill (the encoder on the
    first chunk), then decode; its logits rows keyed as ``_recording``
    keys them."""
    prompt, out_len = s.prompts[i], LENS[i][1]
    ex = RealExecutor(s.model, max_slots=SLOTS, s_kv=S_KV, chunk_pad=CHUNK)
    n = len(prompt)
    for lo in range(0, n, CHUNK):
        hi = min(lo + CHUNK, n)
        tok = ex.prefill_chunk(0, prompt[lo:hi], lo, hi == n,
                               enc_emb=s.encs[i] if lo == 0 else None)
    rows = {(f"r{i}", 0): (ex.last_logits[0].copy(), tok)}
    for t in range(out_len - 1):
        tok = ex.decode({0: tok}, {0: n + t})[0]
        rows[(f"r{i}", t + 1)] = (ex.last_logits[0].copy(), tok)
    return rows


def test_cronus_payload_carries_cross_kv():
    """Mirror of ``tests/test_whisper_serving.py``: the Cronus pair splits
    a request between PPI and CPI, and every emitted token's logits equal
    the unsplit oracle's."""
    s = _setup()
    factory = slot_executor_factory(s.cfg, s.model, device="cpu",
                                    max_slots=SLOTS, s_kv=S_KV,
                                    chunk_pad=CHUNK)
    system = build_system("cronus", s.cfg, hardware.A100, hardware.A30,
                          executor_factory=factory, max_slots=SLOTS,
                          block_size=BLOCK, max_batched_tokens=CHUNK,
                          executor="real")
    reqs = [Request(req_id=f"r{i}", prompt=s.prompts[i].copy(),
                    output_len=LENS[i][1], enc_emb=s.encs[i])
            for i in range(len(LENS))]
    recorded = [_recording(e.executor, e.slots)
                for e in (system.ppi, system.cpi)]
    res = system.run(reqs)
    assert res["completed"] == len(LENS)
    got = {**recorded[0], **recorded[1]}
    assert any(0 < r.partial_len < r.input_len for r in reqs)
    want = {}
    for i in range(len(LENS)):
        want.update(_oracle(s, i))
    assert _compare(got, want) == 0


def test_extract_inject_carries_cross_kv():
    """A partial prefill's payload carries cross-KV beside the self-KV
    prefix; the CPI then gives the unsplit run's logits. The same payload
    with its cross-KV zeroed misses them by far: the check sees a lost
    payload."""
    s = _setup()
    prompt, enc, split = s.prompts[0], s.encs[0], 12
    whole = RealExecutor(s.model, max_slots=2, s_kv=S_KV)
    whole.prefill_chunk(0, prompt, 0, True, enc_emb=enc)
    ppi = RealExecutor(s.model, max_slots=2, s_kv=S_KV)
    ppi.prefill_chunk(1, prompt[:split], 0, False, enc_emb=enc)
    payload = ppi.extract_kv(1, split)
    assert set(payload) == {"stack", "cross_k", "cross_v", "_upto"}
    shape = (s.cfg.n_layers, s.cfg.enc_seq_len, s.cfg.n_kv_heads,
             s.cfg.head_dim)
    assert payload["cross_k"].shape == shape
    lost = dict(payload, cross_k=torch.zeros(shape),
                cross_v=torch.zeros(shape))
    diffs = []
    for pl in (payload, lost):
        cpi = RealExecutor(s.model, max_slots=3, s_kv=S_KV)
        cpi.inject_kv(2, pl, split)
        for k in ("cross_k", "cross_v"):
            assert torch.equal(cpi.cache[k][:, 2], pl[k])
        cpi.prefill_chunk(2, prompt[split:], split, True)
        diffs.append(float(np.abs(cpi.last_logits
                                  - whole.last_logits).max()))
    assert diffs[0] <= TOL and diffs[1] > 100 * TOL, diffs


def test_enc_emb_length_must_match_the_cache():
    s = _setup()
    ex = RealExecutor(s.model, max_slots=1, s_kv=S_KV)
    with pytest.raises(ValueError, match="enc_seq_len"):
        ex.prefill_chunk(0, s.prompts[0], 0, True, enc_emb=s.encs[0][:10])


def test_training_waits_for_the_training_slice():
    s = _setup()
    with pytest.raises(NotImplementedError, match="queue 1 item 11"):
        s.model.forward(s.model.params, torch.zeros((1, 1)), None,
                        torch.zeros((1,)), train=True)
    with pytest.raises(NotImplementedError, match="queue 1 item 11"):
        s.model.loss(s.model.params, {})
