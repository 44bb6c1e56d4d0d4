"""The port's attention kernels on the CPU against the JAX package's.

On a CPU tensor each kernel wrapper computes the plain PyTorch version
(the CUDA kernels have no CPU mode; ``chip_smoke.py`` holds them against
the plain versions on the card). Here the plain versions meet the JAX
package's jnp references and its Pallas kernels in interpret mode, on the
same inputs drawn with numpy: the sweeps of ``tests/test_kernels.py`` and
the ragged / padding-id cases of ``tests/test_paged_executor.py``.

Tolerances are those of the JAX package's own kernel tests: 2e-5 in fp32
(the two frameworks sum in different orders) and 2e-2 in bf16 (one bf16
rounding of outputs of magnitude up to ~4).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jax_ref
from repro.kernels.chunked_prefill_attention import \
    chunked_prefill_attention_pallas as _cp_pallas
from repro.kernels.paged_attention import \
    paged_decode_attention_pallas as _pd_pallas
from repro_torch.kernels import (chunked_prefill_attention, ops,
                                 paged_attention, ref)

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JAX_DT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}

# the JAX side jitted: op-by-op dispatch of the references costs seconds
jax_prefill_ref = jax.jit(jax_ref.chunked_prefill_attention_ref,
                          static_argnums=(5,))
jax_decode_ref = jax.jit(jax_ref.paged_decode_attention_ref)
chunked_prefill_attention_pallas = jax.jit(
    _cp_pallas, static_argnames=("window", "block_q", "block_k", "scale",
                                 "interpret"))
paged_decode_attention_pallas = jax.jit(_pd_pallas,
                                        static_argnames=("interpret",))


def _both(arrays, dtype):
    """numpy fp32 / int32 arrays -> (jax arrays, torch tensors); floats go
    to ``dtype`` in both (round-to-nearest-even in both frameworks)."""
    jx, tx = [], []
    for a in arrays:
        if a.dtype == np.float32:
            jx.append(jnp.asarray(a, JAX_DT[dtype]))
            tx.append(torch.from_numpy(a).to(TORCH_DT[dtype]))
        else:
            jx.append(jnp.asarray(a))
            tx.append(torch.from_numpy(a))
    return jx, tx


def _close(got, want, dtype):
    np.testing.assert_allclose(np.asarray(got.float()) if torch.is_tensor(got)
                               else np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               atol=TOL[dtype], rtol=TOL[dtype])


def _prefill_case(b, c, h, kv, d, s, seed=0):
    """The inputs of tests/test_kernels.py::_mk, drawn with numpy."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, c, h, d), np.float32)
    k = rng.standard_normal((b, s, kv, d), np.float32)
    v = rng.standard_normal((b, s, kv, d), np.float32)
    ctx = np.arange(b) * 5 + 3
    q_pos = (ctx[:, None] + np.arange(c)[None, :]).astype(np.int32)
    kv_pos = np.where(np.arange(s)[None, :] < (ctx + c)[:, None],
                      np.arange(s)[None, :], -1).astype(np.int32)
    return q, k, v, q_pos, kv_pos


@pytest.mark.parametrize("b,c,h,kv,d,s", [
    (1, 8, 4, 4, 32, 32),     # MHA
    (2, 16, 8, 2, 64, 64),    # GQA 4:1
    (2, 8, 8, 1, 64, 64),     # MQA
    (1, 32, 4, 4, 128, 32),   # d=128
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [0, 8])
def test_chunked_prefill_matches_jax(b, c, h, kv, d, s, dtype, window):
    """Plain version == JAX jnp reference == Pallas kernel (interpret)."""
    (jq, jk, jv, jqp, jkp), (tq, tk, tv, tqp, tkp) = _both(
        _prefill_case(b, c, h, kv, d, s), dtype)
    got = ops.chunked_prefill_attention(tq, tk, tv, tqp, tkp, window=window)
    assert got.dtype == TORCH_DT[dtype] and got.shape == (b, c, h, d)
    _close(got, jax_prefill_ref(jq, jk, jv, jqp, jkp,
                                                      window), dtype)
    _close(got, chunked_prefill_attention_pallas(
        jq, jk, jv, jqp, jkp, window=window, block_q=8, block_k=16,
        interpret=True), dtype)


def test_chunked_prefill_ragged_and_scale():
    """Ragged C/S (no padding to tile multiples anywhere in the port) and
    an explicit scale, against the JAX package's padding wrapper."""
    from repro.kernels.ops import chunked_prefill_attention as jax_ops_cp
    arrays = _prefill_case(2, 13, 4, 2, 48, 50)
    (jq, jk, jv, jqp, jkp), (tq, tk, tv, tqp, tkp) = _both(arrays, "float32")
    want = jax_ops_cp(jq, jk, jv, jqp, jkp, use_pallas=True, block_q=8,
                      block_k=16)
    _close(ops.chunked_prefill_attention(tq, tk, tv, tqp, tkp), want,
           "float32")
    # scale: the reference's scores times 2 are the scores at scale 2/sqrt(D)
    got = ref.chunked_prefill_attention_ref(tq, tk, tv, tqp, tkp,
                                            scale=2 * 48 ** -0.5)
    _close(got, jax_prefill_ref(
        jq * 2, jk, jv, jqp, jkp), "float32")


def test_chunked_prefill_row_without_keys_is_zero():
    """A query row with no valid key (all kv padding, or a padded query
    with q_pos = -1) gives zeros, as the Pallas kernel's l == 0 case."""
    q, k, v, q_pos, kv_pos = _prefill_case(1, 8, 4, 2, 32, 16)
    q_pos[0, 5:] = -1
    (jq, jk, jv, jqp, jkp), (tq, tk, tv, tqp, tkp) = _both(
        (q, k, v, q_pos, kv_pos), "float32")
    got = ops.chunked_prefill_attention(tq, tk, tv, tqp, tkp)
    assert torch.count_nonzero(got[0, 5:]) == 0
    _close(got, chunked_prefill_attention_pallas(
        jq, jk, jv, jqp, jkp, block_q=8, block_k=16, interpret=True),
        "float32")


def _decode_case(b, h, kv, d, pages, page, maxp, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, d), np.float32)
    kp = rng.standard_normal((pages, page, kv, d), np.float32)
    vp = rng.standard_normal((pages, page, kv, d), np.float32)
    bt = rng.integers(0, pages, (b, maxp)).astype(np.int32)
    cl = (np.arange(b) * 7 % (maxp * page - 1) + 1).astype(np.int32)
    return q, kp, vp, bt, cl


def _decode_vs_jax(arrays, dtype):
    (jq, jk, jv, jbt, jcl), tx = _both(arrays, dtype)
    got = ops.paged_decode_attention(*tx)
    assert got.dtype == TORCH_DT[dtype] and got.shape == tx[0].shape
    _close(got, jax_decode_ref(jq, jk, jv, jbt, jcl),
           dtype)
    _close(got, paged_decode_attention_pallas(jq, jk, jv, jbt, jcl,
                                              interpret=True), dtype)
    return got


@pytest.mark.parametrize("b,h,kv,d,pages,page,maxp", [
    (2, 8, 2, 64, 16, 8, 4),
    (3, 4, 4, 32, 8, 16, 3),
    (1, 8, 1, 128, 32, 8, 8),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_decode_matches_jax(b, h, kv, d, pages, page, maxp, dtype):
    """Plain version == JAX jnp reference == Pallas kernel (interpret)."""
    _decode_vs_jax(_decode_case(b, h, kv, d, pages, page, maxp), dtype)


@pytest.mark.parametrize("page", [4, 8])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_paged_decode_ragged(page, seed):
    """Ragged context lengths with partial last pages (the sizes of
    tests/test_paged_executor.py::test_paged_decode_kernel_ragged)."""
    rng = np.random.default_rng(seed)
    b, h, kv, d, pages, maxp = 4, 4, 2, 32, 24, 6
    q = rng.standard_normal((b, h, d), np.float32)
    kp = rng.standard_normal((pages, page, kv, d), np.float32)
    vp = rng.standard_normal((pages, page, kv, d), np.float32)
    bt = rng.integers(0, pages, (b, maxp)).astype(np.int32)
    cl = np.asarray([maxp * page] + list(rng.integers(1, maxp * page, b - 1)),
                    np.int32)
    _decode_vs_jax((q, kp, vp, bt, cl), "float32")


def test_paged_decode_padding_id_invariance():
    """Table entries past ceil(ctx / page) are dead: any page id there
    (the executor pads with the trash page) leaves the output unchanged."""
    rng = np.random.default_rng(3)
    b, h, kv, d, pages, page = 2, 4, 2, 32, 16, 4
    q = torch.from_numpy(rng.standard_normal((b, h, d), np.float32))
    kp = torch.from_numpy(rng.standard_normal((pages, page, kv, d),
                                              np.float32))
    vp = torch.from_numpy(rng.standard_normal((pages, page, kv, d),
                                              np.float32))
    cl = torch.tensor([5, 9], dtype=torch.int32)     # 2 and 3 live pages
    bt = torch.tensor([[1, 2, 3, 4], [5, 6, 7, 8]], dtype=torch.int32)
    base = ops.paged_decode_attention(q, kp, vp, bt, cl)
    for junk in (0, pages - 1):
        bt2 = bt.clone()
        bt2[0, 2:] = junk
        bt2[1, 3:] = junk
        assert torch.equal(ops.paged_decode_attention(q, kp, vp, bt2, cl),
                           base)


def test_paged_decode_zero_context_row():
    """A padded decode lane (ctx = 0, trash table) gives zeros, as the
    Pallas kernel does; the live rows still match it."""
    q, kp, vp, bt, cl = _decode_case(3, 8, 2, 64, 16, 8, 4)
    cl[1] = 0
    bt[1] = 15                                   # the trash page
    (jq, jk, jv, jbt, jcl), tx = _both((q, kp, vp, bt, cl), "float32")
    got = ops.paged_decode_attention(*tx)
    assert torch.count_nonzero(got[1]) == 0
    _close(got, paged_decode_attention_pallas(jq, jk, jv, jbt, jcl,
                                              interpret=True), "float32")


def test_paged_decode_context_past_the_table():
    """A context longer than the table covers counts as the table's full
    width (the JAX reference's masking, which the CUDA kernel clamps to)."""
    q, kp, vp, bt, cl = _decode_case(3, 8, 2, 64, 16, 8, 4)
    full = cl.copy()
    full[0], full[2] = 4 * 8, 4 * 8
    cl[0], cl[2] = 4 * 8 + 5, 10 ** 6
    (jq, jk, jv, jbt, jcl), tx = _both((q, kp, vp, bt, cl), "float32")
    got = ops.paged_decode_attention(*tx)
    _close(got, jax_decode_ref(jq, jk, jv, jbt, jcl), "float32")
    assert torch.equal(got, ops.paged_decode_attention(
        *tx[:4], torch.from_numpy(full)))


def test_cpu_tensors_take_the_plain_version():
    """On CPU tensors the kernel wrappers compute the plain version and
    launch nothing: the launch counters stay at 0."""
    paged_attention.launches = 0
    chunked_prefill_attention.launches = 0
    dq, dk, dv, dbt, dcl = (torch.from_numpy(a) for a in
                            _decode_case(2, 8, 2, 64, 16, 8, 4))
    want = ref.paged_decode_attention_ref(dq, dk, dv, dbt, dcl)
    for got in (paged_attention.paged_decode_attention(dq, dk, dv, dbt, dcl),
                ops.paged_decode_attention(dq, dk, dv, dbt, dcl,
                                           use_kernels=True)):
        assert torch.equal(got, want)
    pq, pk, pv, pqp, pkp = (torch.from_numpy(a) for a in
                            _prefill_case(2, 16, 8, 2, 64, 64))
    want = ref.chunked_prefill_attention_ref(pq, pk, pv, pqp, pkp, 8)
    got = chunked_prefill_attention.chunked_prefill_attention(
        pq, pk, pv, pqp, pkp, window=8)
    assert torch.equal(got, want)
    assert paged_attention.launches == 0
    assert chunked_prefill_attention.launches == 0


def test_kernel_wrappers_refuse_what_the_kernels_do_not_take():
    """The checks that run before a launch: dtype, shape, contiguity and,
    last, the device (CPU tensors pass every check but that one)."""
    q, kp, vp, bt, cl = (torch.from_numpy(a) for a in
                         _decode_case(2, 8, 2, 64, 16, 8, 4))
    check = paged_attention._check
    with pytest.raises(TypeError):
        check(q.half(), kp.half(), vp.half(), bt, cl)
    with pytest.raises(TypeError):
        check(q, kp, vp, bt.long(), cl)
    with pytest.raises(ValueError, match="unsupported"):
        check(q[..., :48].contiguous(), kp[..., :48].contiguous(),
              vp[..., :48].contiguous(), bt, cl)
    with pytest.raises(ValueError, match="contiguous"):
        check(q, kp, vp, bt.t().contiguous().t(), cl)
    with pytest.raises(ValueError, match="CUDA"):
        check(q, kp, vp, bt, cl)

    pq, pk, pv, pqp, pkp = (torch.from_numpy(a) for a in
                            _prefill_case(1, 8, 4, 2, 32, 16))
    check = chunked_prefill_attention._check
    with pytest.raises(TypeError):
        check(pq, pk.bfloat16(), pv, pqp, pkp, 0)
    with pytest.raises(ValueError, match="unsupported"):
        check(pq, pk, pv, pqp[:, :4].contiguous(), pkp, 0)
    with pytest.raises(ValueError, match="unsupported"):
        check(pq, pk, pv, pqp, pkp, -1)
    with pytest.raises(ValueError, match="contiguous"):
        check(pq.transpose(1, 2).contiguous().transpose(1, 2), pk, pv, pqp,
              pkp, 0)
    with pytest.raises(ValueError, match="CUDA"):
        check(pq, pk, pv, pqp, pkp, 0)
