"""The CUDA kernels' algorithms, modelled in PyTorch, against the JAX package.

The kernels themselves run only on the card (``chip_smoke.py`` holds them
against the plain versions there). What can be checked here is their
algorithm: ``kernels/ref.py`` models the decode kernel's split-K with its
merge (``paged_decode_attention_split_ref``) and the prefill kernel's
tile-by-tile online softmax with its skip rule and P rounded to the
working dtype (``chunked_prefill_attention_tiled_ref``). Both meet the JAX
package's Pallas kernels in interpret mode and its jnp references on the
same numpy-drawn inputs, at the tolerances of ``test_torch_kernels.py``:
2e-5 in fp32, 2e-2 in bf16.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jax_ref
from repro.kernels.ops import chunked_prefill_attention as jax_ops_prefill
from repro.kernels.paged_attention import \
    paged_decode_attention_pallas as _pd_pallas
from repro_torch.kernels import ref

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JAX_DT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}

jax_prefill_ref = jax.jit(jax_ref.chunked_prefill_attention_ref,
                          static_argnums=(5,))
jax_decode_ref = jax.jit(jax_ref.paged_decode_attention_ref)
# the Pallas prefill kernel behind the JAX package's padding wrapper (it
# pads ragged C/S to its tiles and D to 128), in interpret mode
prefill_pallas = jax.jit(jax_ops_prefill, static_argnames=(
    "window", "use_pallas", "block_q", "block_k", "interpret"))
decode_pallas = jax.jit(_pd_pallas, static_argnames=("interpret",))


def _both(arrays, dtype):
    """numpy fp32 / int32 arrays -> (jax arrays, torch tensors)."""
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
    np.testing.assert_allclose(np.asarray(got.float()),
                               np.asarray(want, np.float32),
                               atol=TOL[dtype], rtol=TOL[dtype])


# ---------------------------------------------------------------------------
# decode: split-K and merge
# ---------------------------------------------------------------------------

def _decode_case(b, h, kv, d, pages, page, maxp, ctx, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, d), np.float32)
    kp = rng.standard_normal((pages, page, kv, d), np.float32)
    vp = rng.standard_normal((pages, page, kv, d), np.float32)
    bt = rng.integers(0, pages, (b, maxp)).astype(np.int32)
    return q, kp, vp, bt, np.asarray(ctx, np.int32)


# contexts of 1..3 splits of `page` tokens, ragged last splits, a lane with
# no context and a lane at the table's full width
DECODE_CTX = [29, 0, 1, 8, 17, 32]


@pytest.mark.parametrize("split", ["page", "3page", "past_context"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_split_decode_matches_jax(split, dtype):
    """Splits of one page, of three pages and longer than any context give
    the Pallas kernel's result; the ctx = 0 lane is exactly zero."""
    b, h, kv, d, pages, page, maxp = 6, 8, 2, 32, 24, 4, 8
    arrays = _decode_case(b, h, kv, d, pages, page, maxp, DECODE_CTX)
    split_tokens = {"page": page, "3page": 3 * page,
                    "past_context": 4 * maxp * page}[split]
    (jq, jk, jv, jbt, jcl), tx = _both(arrays, dtype)
    got = ref.paged_decode_attention_split_ref(*tx, split_tokens=split_tokens)
    assert got.dtype == TORCH_DT[dtype] and got.shape == (b, h, d)
    assert torch.count_nonzero(got[1]) == 0
    _close(got, decode_pallas(jq, jk, jv, jbt, jcl, interpret=True), dtype)
    live = [i for i, c in enumerate(DECODE_CTX) if c > 0]
    _close(got[live], np.asarray(jax_decode_ref(jq, jk, jv, jbt, jcl))[live],
           dtype)


@pytest.mark.parametrize("b,h,kv,d,page,split", [
    (3, 8, 8, 64, 8, 16),       # MHA, two pages a split
    (3, 16, 2, 128, 16, 16),    # G = 8, one page a split
    (3, 12, 4, 32, 4, 12),      # G = 3, a split of three pages
])
def test_split_decode_shapes(b, h, kv, d, page, split):
    """Head dims, GQA ratios and page sizes the kernel takes, against the
    jnp reference and the plain version."""
    maxp = 6
    ctx = [maxp * page, 1, split + 1][:b]
    arrays = _decode_case(b, h, kv, d, 4 * maxp, page, maxp, ctx, seed=1)
    (jq, jk, jv, jbt, jcl), tx = _both(arrays, "float32")
    got = ref.paged_decode_attention_split_ref(*tx, split_tokens=split)
    _close(got, jax_decode_ref(jq, jk, jv, jbt, jcl), "float32")
    _close(got, ref.paged_decode_attention_ref(*tx), "float32")


def test_split_decode_context_past_the_table():
    """A context longer than the table covers counts as the table's full
    width, as in the jnp reference (the kernel clamps it the same way)."""
    b, h, kv, d, pages, page, maxp = 3, 8, 2, 64, 16, 8, 4
    arrays = _decode_case(b, h, kv, d, pages, page, maxp,
                          [maxp * page + 5, 10 ** 6, 9])
    (jq, jk, jv, jbt, jcl), tx = _both(arrays, "float32")
    got = ref.paged_decode_attention_split_ref(*tx, split_tokens=2 * page)
    _close(got, jax_decode_ref(jq, jk, jv, jbt, jcl), "float32")
    full = tx[:4] + [torch.tensor([maxp * page, maxp * page, 9],
                                  dtype=torch.int32)]
    assert torch.equal(got, ref.paged_decode_attention_split_ref(
        *full, split_tokens=2 * page))


# ---------------------------------------------------------------------------
# prefill: tiles, skip rule, P in the working dtype
# ---------------------------------------------------------------------------

def _prefill_arrays(b, c, h, kv, d, s, q_pos, kv_pos, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, c, h, d), np.float32),
            rng.standard_normal((b, s, kv, d), np.float32),
            rng.standard_normal((b, s, kv, d), np.float32),
            np.asarray(q_pos, np.int32), np.asarray(kv_pos, np.int32))


def _bucket_positions(b, c, s, real_c, ctx):
    """The executor's buckets: ``real_c`` queries after ``ctx`` cached
    tokens, padded to ``c`` with -1, keys padded to ``s`` with -1."""
    q_pos = np.where(np.arange(c) < real_c, ctx + np.arange(c), -1)
    kv_pos = np.where(np.arange(s) < ctx + real_c, np.arange(s), -1)
    return np.tile(q_pos, (b, 1)), np.tile(kv_pos, (b, 1))


PREFILL_CASES = {
    # name: (b, c, h, kv, d, s, real_c, ctx, window)
    "padded_query_tail": (1, 32, 4, 2, 32, 48, 19, 20, 0),
    "kv_pos_tail": (2, 16, 8, 2, 64, 64, 16, 5, 0),
    "window_skips_leading_tiles": (1, 16, 4, 4, 32, 96, 16, 70, 12),
    "ragged_c_s": (2, 13, 4, 2, 64, 50, 13, 30, 0),
    "ragged_window": (1, 21, 8, 1, 32, 37, 21, 10, 8),
}


@pytest.mark.parametrize("name", list(PREFILL_CASES))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("tiles", [(8, 8), (128, 64)])
def test_tiled_prefill_matches_jax(name, dtype, tiles):
    """Small tiles (many of them skipped) and the kernel's own tile sizes
    give the jnp reference's and the Pallas kernel's result."""
    b, c, h, kv, d, s, real_c, ctx, window = PREFILL_CASES[name]
    q_pos, kv_pos = _bucket_positions(b, c, s, real_c, ctx)
    (jq, jk, jv, jqp, jkp), tx = _both(
        _prefill_arrays(b, c, h, kv, d, s, q_pos, kv_pos), dtype)
    rows, keys = tiles
    got = ref.chunked_prefill_attention_tiled_ref(*tx, window, rows=rows,
                                                  keys=keys)
    assert got.dtype == TORCH_DT[dtype] and got.shape == (b, c, h, d)
    assert torch.count_nonzero(got[:, real_c:]) == 0    # padded queries
    # the jnp reference averages a padded query's masked row; the Pallas
    # kernel gives zeros there, as the port does
    _close(got[:, :real_c], np.asarray(jax_prefill_ref(
        jq, jk, jv, jqp, jkp, window))[:, :real_c], dtype)
    _close(got, prefill_pallas(jq, jk, jv, jqp, jkp, window=window,
                               use_pallas=True, block_q=8, block_k=16,
                               interpret=True), dtype)


def test_tiled_prefill_explicit_scale_and_unsorted_positions():
    """An explicit scale, and positions in no order (the rule assumes
    none): the plain version's result."""
    rng = np.random.default_rng(5)
    b, c, h, kv, d, s = 1, 24, 4, 2, 32, 40
    q_pos = rng.permutation(np.arange(10, 10 + c))[None]
    q_pos[0, 3] = -1
    kv_pos = rng.permutation(np.arange(s))[None]
    kv_pos[0, rng.integers(0, s, 6)] = -1
    _, tx = _both(_prefill_arrays(b, c, h, kv, d, s, q_pos, kv_pos),
                  "float32")
    for window in (0, 7):
        got = ref.chunked_prefill_attention_tiled_ref(
            *tx, window, 0.3, rows=8, keys=8)
        _close(got, ref.chunked_prefill_attention_ref(*tx, window, 0.3),
               "float32")


@pytest.mark.parametrize("seed", range(4))
def test_skipped_tiles_hold_no_valid_pair(seed):
    """Every (query tile, key tile) the rule skips holds no valid pair, for
    random unsorted positions with padding; and the rule does skip."""
    rng = np.random.default_rng(seed)
    skipped = 0
    for _ in range(300):
        # runs of positions at random offsets, shuffled or not, with holes
        q_pos = int(rng.integers(0, 200)) + np.arange(16)
        kv_pos = int(rng.integers(0, 200)) + np.arange(8)
        if rng.random() < 0.5:
            q_pos, kv_pos = rng.permutation(q_pos), rng.permutation(kv_pos)
        q_pos[rng.random(16) < 0.2] = -1
        kv_pos[rng.random(8) < 0.2] = -1
        window = int(rng.choice([0, 4, 16, 64]))
        valid = (kv_pos[None] >= 0) & (kv_pos[None] <= q_pos[:, None])
        if window > 0:
            valid &= kv_pos[None] > q_pos[:, None] - window
        valid &= (q_pos >= 0)[:, None]
        live = ref.prefill_tile_live(torch.from_numpy(q_pos),
                                     torch.from_numpy(kv_pos), window)
        if not live:
            skipped += 1
            assert not valid.any(), (q_pos, kv_pos, window)
    assert skipped > 0
