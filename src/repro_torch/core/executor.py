"""Executors: the compute backends of the serving engines.

``RealExecutor`` runs real PyTorch forwards on a slot-based cache (one
``[s_kv]`` row of K/V per slot; functional correctness at reduced scale).
``PagedRealExecutor`` runs the same math over a block-pool KV layout
driven by the engine's live :class:`~repro_torch.kvcache.BlockAllocator`
tables — attention reads exactly the blocks a request owns (through
:mod:`repro_torch.kernels.ops`), so prefix-cache hits, copy-on-write
shares and Cronus PPI→CPI handoffs work on real compute.
``NullExecutor`` skips compute entirely (scheduling + timing studies at
paper scale). All sit behind the same interface, so the scheduler /
balancer code is identical.

Slot invariant: validity of a cache position is defined by the host's
``kv_positions`` alone, which only ever advance for the slots that take
part in a forward; freed slots reset their position row to -1. The JAX
package runs every slot's row in each forward (fixed jit shapes) and lets
the rows that sit out write garbage beyond their valid region; here a
forward runs only the rows of the slots that take part, so the others
are neither read nor written.

The paged pool's invariant: padded/inactive lanes write into a dedicated
trash page that no block table references, and attention masks by
``context_lens`` / kv positions, never by content.

Unlike the JAX package, whose jitted forwards returned new cache arrays,
the slot cache and the pools are updated in place (indexed stores,
``index_copy_`` and slice assignment): at full width they are gigabytes
and are never copied.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels import ops
from repro_torch.models.layers import rmsnorm, swiglu
from repro_torch.models.rope import position_encode


def _pow2_bucket(n: int, lo: int = 16) -> int:
    b = lo
    while b < n:
        b *= 2
    return b


class BucketCache:
    """Single home for power-of-two shape bucketing + dispatch accounting.

    Executors funnel all shape choices through one instance, and
    ``compile_stats()`` counts the distinct bucketed shapes and the
    dispatches of each kind. (In the JAX package each new shape was one
    XLA compilation; here it bounds the distinct kernel launch shapes, and
    tests assert the same budget.)
    """

    def __init__(self):
        self._shapes: Dict[str, Dict[Tuple[int, ...], int]] = {}

    def bucket(self, n: int, lo: int = 16) -> int:
        """Smallest power-of-two multiple of ``lo`` that holds ``n``."""
        return _pow2_bucket(n, lo)

    def record(self, kind: str, *shape: int) -> bool:
        """Note one dispatch of ``kind`` at a bucketed ``shape``. Returns
        True when the shape is new."""
        seen = self._shapes.setdefault(kind, {})
        new = shape not in seen
        seen[shape] = seen.get(shape, 0) + 1
        return new

    def compile_stats(self) -> Dict[str, int]:
        """Per-kind distinct shapes, plus totals."""
        out = {kind: len(seen) for kind, seen in self._shapes.items()}
        out["total_shapes"] = sum(len(s) for s in self._shapes.values())
        out["dispatches"] = sum(c for s in self._shapes.values()
                                for c in s.values())
        return out


# Margin for deterministic greedy tie-breaking. Results carry small
# environment-dependent jitter (reduction order, ~1e-4 with fp32); plain
# argmax then flips near-ties and the token stream cascades. Reproducible
# serving instead picks the LOWEST token id among all logits within this
# margin of the max — stable under jitter << margin.
GREEDY_TIE_MARGIN = 0.05


def robust_greedy(logits_row) -> int:
    """Lowest token id whose logit is within the margin of the max."""
    row = np.asarray(logits_row, np.float32)
    top = row.max()
    return int(np.nonzero(row >= top - GREEDY_TIE_MARGIN)[0][0])


class NullExecutor:
    """No compute; emits deterministic dummy tokens."""

    def __init__(self):
        self._counter = 0

    def prefill_chunk(self, slot, tokens, ctx_len, completes, enc_emb=None):
        """Dummy first token when the prompt completes."""
        if completes:
            self._counter += 1
            return self._counter
        return None

    def decode(self, slot_tokens: Dict[int, int], slot_lens: Dict[int, int]):
        """One dummy token per slot."""
        out = {}
        for s in slot_tokens:
            self._counter += 1
            out[s] = self._counter
        return out

    def extract_kv(self, slot, upto):
        """A placeholder payload."""
        return {"_null": upto}

    def inject_kv(self, slot, payload, upto):
        """Nothing to install."""

    def reset_slot(self, slot):
        """Nothing to scrub."""


class RealExecutor:
    """PyTorch execution over a slot-based unified cache with
    host-managed positions. A prefill chunk runs at its own length: the
    JAX package pads it to a power-of-two bucket (or to ``chunk_pad``) to
    keep jit shapes fixed, and its padded tokens' K/V land on ring
    positions that can still be valid once ``ctx + bucket > s_kv``.
    Eager PyTorch recompiles nothing, so the port writes only the real
    tokens; ``compile_stats`` still counts the JAX package's buckets.

    Supported model families: dense-attention stacks ("mlp" kind), the
    only ones :class:`~repro_torch.models.transformer.DecoderModel` lays
    out so far (the SSM-state restore and the cross-KV install of the
    JAX executor come with those families).
    """

    def __init__(self, model, params=None, *, max_slots: int, s_kv: int,
                 chunk_pad: Optional[int] = None):
        self.model = model
        self.params = model.params if params is None else params
        self.cfg = model.cfg
        self.max_slots = max_slots
        self.s_kv = s_kv
        # the JAX package's fixed chunk width (bucket accounting only)
        self.chunk_pad = chunk_pad
        self.cache = model.init_cache(max_slots, s_kv)
        self.device = self.cache["pos"].device
        self.pos = np.full((max_slots, s_kv), -1, np.int32)   # host positions
        self.lens = np.zeros((max_slots,), np.int32)          # host lengths
        self.buckets = BucketCache()
        # host copy of the newest logits block (prefill: [1, V] when the
        # prompt completes; decode: [n, V] in slot order), for parity checks
        self.last_logits: Optional[np.ndarray] = None

    def compile_stats(self) -> Dict[str, int]:
        """Distinct bucketed dispatch shapes per kind (see BucketCache)."""
        return self.buckets.compile_stats()

    # ------------------------------------------------------------------
    def _tensor(self, a: np.ndarray, dtype=torch.int32) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(
            device=self.device, dtype=dtype)

    def _run(self, slots, inputs: np.ndarray,
             positions: np.ndarray) -> torch.Tensor:
        """Forward the rows of ``slots`` (inputs/positions ``[n, cb]``)
        against the cache; returns logits ``[n, cb, V]``."""
        rows = np.asarray(slots, np.int64)
        logits, self.cache, _ = self.model.forward(
            self.params, self._tensor(inputs, torch.long), self.cache,
            self._tensor(self.lens[rows]),
            positions=self._tensor(positions),
            kv_positions=self._tensor(self.pos[rows]),
            rows=self._tensor(rows, torch.long))
        return logits

    @torch.no_grad()
    def prefill_chunk(self, slot: int, tokens: np.ndarray, ctx_len: int,
                      completes: bool, enc_emb=None) -> Optional[int]:
        """Run one prefill chunk for ``slot``. Returns the first token if
        the prompt completes with this chunk."""
        c = len(tokens)
        if self.chunk_pad and c <= self.chunk_pad:
            cb = self.chunk_pad
        else:
            cb = self.buckets.bucket(c)
        self.buckets.record("prefill", cb)
        positions = ctx_len + np.arange(c, dtype=np.int32)
        # mark the new positions valid for this slot (host side)
        self.pos[slot, positions % self.s_kv] = positions
        logits = self._run([slot], np.asarray(tokens, np.int32)[None],
                           positions[None])
        self.lens[slot] = ctx_len + c
        if not completes:
            return None
        self.last_logits = logits[:, c - 1].float().cpu().numpy()
        return robust_greedy(self.last_logits[0])

    @torch.no_grad()
    def decode(self, slot_tokens: Dict[int, int],
               slot_lens: Dict[int, int]) -> Dict[int, int]:
        """One decode step for the given slots. Returns slot -> next
        token."""
        self.buckets.record("decode", 1)
        slots = sorted(slot_tokens)
        inputs = np.zeros((len(slots), 1), np.int32)
        positions = np.zeros((len(slots), 1), np.int32)
        for i, s in enumerate(slots):
            inputs[i, 0] = slot_tokens[s]
            positions[i, 0] = slot_lens[s]
            self.pos[s, slot_lens[s] % self.s_kv] = slot_lens[s]
        logits = self._run(slots, inputs, positions)
        self.last_logits = logits[:, 0].float().cpu().numpy()
        out = {}
        for i, s in enumerate(slots):
            out[s] = robust_greedy(self.last_logits[i])
            self.lens[s] = slot_lens[s] + 1
        return out

    # ------------------------------------------------------------------
    # KV handoff. The attention caches carry a sequence axis at dim 2 of
    # each [L, slot, S_kv, ...] leaf; only the first ``upto`` positions
    # are valid at extract time, so only they travel — the PPI->CPI
    # payload is sized by the partial prefill, not by the slot width.
    _SEQ_KEYS = frozenset(("k", "v", "ckv", "kpe"))

    def extract_kv(self, slot: int, upto: int):
        """Pull one slot's cache slices (the PPI->CPI payload): a copy on
        the device, since the PPI reuses the slot before the simulated
        transfer delivers it."""
        def take(key, a):
            return (a[:, slot, :upto] if key in self._SEQ_KEYS
                    else a[:, slot]).clone()

        return {"stack": {k: take(k, a)
                          for k, a in self.cache["stack"].items()},
                "_upto": upto}

    @torch.no_grad()
    def inject_kv(self, slot: int, payload, upto: int):
        """Install a transferred payload into ``slot``, in place, and mark
        ``[0, upto)`` valid."""
        for k, dst in self.cache["stack"].items():
            src = payload["stack"][k].to(device=self.device,
                                         dtype=dst.dtype)
            if k in self._SEQ_KEYS:
                dst[:, slot, :src.shape[1]] = src
            else:
                dst[:, slot] = src
        self.pos[slot, :] = -1
        self.pos[slot, :upto] = np.arange(upto)
        self.lens[slot] = upto

    def reset_slot(self, slot: int):
        """Forget the slot's positions: its cache rows become garbage that
        no position marks valid."""
        self.pos[slot, :] = -1
        self.lens[slot] = 0


class PagedRealExecutor:
    """PyTorch execution over a block-pool KV cache driven by the engine's
    live block tables.

    Layout: K and V pools of shape ``[L, num_blocks + 1, block_size,
    n_kv_heads, head_dim]``. Pool row ``i`` *is* allocator block ``i`` —
    the engine's :class:`~repro_torch.kvcache.BlockAllocator` decides
    placement and this executor just reads/writes through the tables, so:

      * prefix-cache hits skip real prefill compute (retained blocks keep
        their K/V rows; ``share_blocks`` only bumps refcounts),
      * copy-on-write divergence clones one block row (the allocator's
        ``on_cow`` hook, registered at :meth:`attach_engine`),
      * Cronus PPI→CPI ``extract_kv``/``inject_kv`` move only the blocks
        covering the partial prefill — and skip positions the target's
        cache already shares.

    The extra pool row (index ``num_blocks``) is a trash page: padded batch
    lanes and padded chunk tokens write their garbage K/V there. No block
    table ever references it, and attention masks strictly by positions /
    ``context_lens``, so garbage is never read.

    Decode runs :func:`repro_torch.kernels.ops.paged_decode_attention` over
    the pool + block tables; prefill chunks run
    :func:`repro_torch.kernels.ops.chunked_prefill_attention` over the
    request's gathered pages. ``use_kernels=None`` picks the CUDA kernels
    when the model lies on a CUDA device and the plain versions on the CPU;
    ``use_kernels=False`` on CUDA runs the plain versions, for parity
    checks that ask for them.

    Supported model families: dense-attention stacks ("mlp" kind, e.g.
    llama3) without sliding windows.
    """

    # Pool rows are materialized for real — refuse the simulated device
    # HBM budgets (tens of thousands of blocks) that the builders default
    # to, and demand an explicit ``num_kv_blocks`` override instead.
    MAX_POOL_BLOCKS = 8192

    def __init__(self, model, params=None, *,
                 use_kernels: Optional[bool] = None):
        cfg = model.cfg
        kind = model._stack_kind()
        if kind != "mlp" or model.is_mla or model.n_dense:
            raise NotImplementedError(
                f"PagedRealExecutor supports dense-attention stacks only "
                f"(got stack kind {kind!r})")
        if cfg.enc_dec or cfg.embeddings_input:
            raise NotImplementedError(
                "PagedRealExecutor does not support encoder/decoder or "
                "embedding-input models")
        if any(cfg.layer_window(i) for i in range(cfg.n_layers)):
            raise NotImplementedError(
                "PagedRealExecutor does not support sliding-window layers "
                "(paged decode attends the whole table)")
        self.model = model
        self.params = model.params if params is None else params
        self.cfg = cfg
        self.device = self.params["embed"].device
        if use_kernels is None:
            use_kernels = self.device.type == "cuda"
        if use_kernels and self.device.type != "cuda":
            raise ValueError("use_kernels=True needs the model on a CUDA "
                             "device: the CUDA kernels have no CPU mode")
        self.use_kernels = bool(use_kernels)
        self.buckets = BucketCache()
        self._engine = None
        self._allocator = None
        self.page: Optional[int] = None
        self.k_pool: Optional[torch.Tensor] = None     # [L, P+1, page, Kv, D]
        self.v_pool: Optional[torch.Tensor] = None
        self._trash: Optional[int] = None
        self._host_store: Dict[bytes, tuple] = {}   # chain hash -> (K, V)
        # host copy of the newest logits block (prefill: [1, V] when the
        # prompt completes; decode: [n, V]), for parity checks
        self.last_logits: Optional[np.ndarray] = None

    def compile_stats(self) -> Dict[str, int]:
        """Distinct bucketed dispatch shapes per kind (see BucketCache)."""
        return self.buckets.compile_stats()

    # ------------------------------------------------------------------
    # engine attachment: pool sizing + allocator hooks
    # ------------------------------------------------------------------
    def attach_engine(self, engine) -> None:
        """Bind to the engine whose allocator drives this pool (called by
        ``Engine.__init__``). Sizes the physical pool from the engine's
        ``num_kv_blocks`` and registers the copy-on-write clone hook."""
        ecfg = engine.ecfg
        if ecfg.num_kv_blocks > self.MAX_POOL_BLOCKS:
            raise ValueError(
                f"paged executor would materialize {ecfg.num_kv_blocks} real "
                f"KV blocks (> {self.MAX_POOL_BLOCKS}); that default comes "
                "from the simulated device HBM budget — pass an explicit "
                "num_kv_blocks override sized for the real run")
        cfg = self.cfg
        self.page = ecfg.block_size
        self._trash = ecfg.num_kv_blocks
        shape = (self.model.n_stack, ecfg.num_kv_blocks + 1, self.page,
                 cfg.n_kv_heads, cfg.head_dim)
        self.k_pool = torch.zeros(shape, dtype=self.model.dtype,
                                  device=self.device)
        self.v_pool = torch.zeros(shape, dtype=self.model.dtype,
                                  device=self.device)
        self._engine = engine
        self._hook_allocator(engine.allocator)

    def _hook_allocator(self, alloc) -> None:
        if alloc is self._allocator:
            return
        assert alloc.block_size == self.page, \
            "allocator block size changed under the paged pool"
        assert alloc.num_blocks <= self._trash, \
            "allocator grew past the physical pool"
        alloc.on_cow = self._clone_block
        # host-memory tier hooks: demotions copy the pool row out to host
        # DRAM before the allocator recycles it, promotions write it back
        alloc.on_demote = self._save_block
        alloc.on_promote = self._restore_block
        alloc.on_host_evict = self._drop_host
        self._allocator = alloc
        self._host_store = {}

    def _to_host(self, t: torch.Tensor) -> torch.Tensor:
        """Copy ``t`` into (pinned, when it lies on the card) host memory."""
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=t.is_cuda)
        host.copy_(t)
        return host

    def _save_block(self, blk: int, key: bytes) -> None:
        """Allocator demotion hook: the pool row is about to be recycled —
        copy its K/V out to the host store (fires while the row is still
        intact, before the block returns to the free list)."""
        self.buckets.record("host_demote", 1)
        self._host_store[key] = (self._to_host(self.k_pool[:, blk]),
                                 self._to_host(self.v_pool[:, blk]))

    def _restore_block(self, blk: int, key: bytes) -> None:
        """Allocator promotion hook: a host-resident chain got a prefix
        hit — write its K/V back into the newly assigned pool row."""
        k, v = self._host_store.pop(key)
        self.buckets.record("host_promote", 1)
        self.k_pool[:, blk].copy_(k)
        self.v_pool[:, blk].copy_(v)

    def _drop_host(self, key: bytes) -> None:
        """Allocator host-eviction hook (capacity pressure, or the pool
        re-registered the same chain): forget the stored row."""
        self._host_store.pop(key, None)

    def _alloc(self):
        """The engine's CURRENT allocator (tests swap allocators to model
        migration; the pool follows, re-registering the CoW hook)."""
        self._hook_allocator(self._engine.allocator)
        return self._allocator

    def _req_id(self, slot: int) -> str:
        req = self._engine.slots[slot]
        assert req is not None, f"executor touched empty slot {slot}"
        return req.req_id

    def _clone_block(self, dst: int, src: int, n_tokens: int) -> None:
        """Allocator CoW hook: copy the first ``n_tokens`` rows of block
        ``src`` into ``dst``, in place (the rest of ``dst`` is garbage
        until prefill/decode writes it)."""
        self.buckets.record("cow", 1)
        self.k_pool[:, dst, :n_tokens] = self.k_pool[:, src, :n_tokens]
        self.v_pool[:, dst, :n_tokens] = self.v_pool[:, src, :n_tokens]

    # ------------------------------------------------------------------
    # forwards: a Python loop over the stacked layers
    # ------------------------------------------------------------------
    def _tensor(self, a: np.ndarray, dtype=torch.int32) -> torch.Tensor:
        return torch.from_numpy(a).to(device=self.device, dtype=dtype)

    def _qkv(self, i: int, x: torch.Tensor, positions: torch.Tensor):
        cfg = self.cfg
        b, sq, _ = x.shape
        ap = self.params["layers"]["attn"]
        q = (x @ ap["wq"][i]).reshape(b, sq, cfg.n_heads, cfg.head_dim)
        k = (x @ ap["wk"][i]).reshape(b, sq, cfg.n_kv_heads, cfg.head_dim)
        v = (x @ ap["wv"][i]).reshape(b, sq, cfg.n_kv_heads, cfg.head_dim)
        if cfg.qk_norm:
            q = rmsnorm(q, ap["q_norm"][i], cfg.norm_eps)
            k = rmsnorm(k, ap["k_norm"][i], cfg.norm_eps)
        return (position_encode(q, positions, cfg),
                position_encode(k, positions, cfg), v)

    @staticmethod
    def _write(pool: torch.Tensor, rows: torch.Tensor,
               write_idx: torch.Tensor) -> None:
        """Scatter token K/V rows into one layer's pool, in place.
        pool [P+1, page, Kv, D]; rows [n, Kv, D]; write_idx [n] (int64)
        flat slots (block_id * page + offset; trash for padded lanes —
        duplicate indices only ever land in the trash row)."""
        flat = pool.view((-1,) + pool.shape[2:])
        flat.index_copy_(0, write_idx, rows.to(flat.dtype))

    def _attn_out(self, i: int, x: torch.Tensor,
                  out: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        lp = self.params["layers"]
        x = x + out.reshape(out.shape[:2] + (cfg.n_heads * cfg.head_dim,)) \
            @ lp["attn"]["wo"][i]
        h2 = rmsnorm(x, lp["ln2"][i], cfg.norm_eps)
        mlp = lp["mlp"]
        return x + swiglu(h2, mlp["w_gate"][i], mlp["w_up"][i],
                          mlp["w_down"][i])

    def _finish(self, x: torch.Tensor) -> torch.Tensor:
        """Final norm + LM head -> logits."""
        p = self.params
        x = rmsnorm(x, p["final_norm"], self.cfg.norm_eps)
        head = p["embed"].T if self.cfg.tie_embeddings else p["head"]
        return x @ head.to(x.dtype)

    def _prefill_fwd(self, tokens, positions, write_idx, table, total):
        """tokens/positions [1, Cb] (-1-padded); write_idx [Cb] flat pool
        slots; table [Pb] page ids (trash-padded); total: valid context
        length after this chunk. Returns the final hidden states."""
        cfg = self.cfg
        kvh, hd = cfg.n_kv_heads, cfg.head_dim
        lp = self.params["layers"]
        x = self.params["embed"][tokens]
        s = table.shape[0] * self.page
        iota = torch.arange(s, dtype=torch.int32, device=self.device)
        kv_pos = torch.where(iota < total, iota, -1)[None]
        for i in range(self.model.n_stack):
            hx = rmsnorm(x, lp["ln1"][i], cfg.norm_eps)
            q, k, v = self._qkv(i, hx, positions)
            kp, vp = self.k_pool[i], self.v_pool[i]
            self._write(kp, k[0], write_idx)
            self._write(vp, v[0], write_idx)
            kg = kp[table].reshape(1, s, kvh, hd)
            vg = vp[table].reshape(1, s, kvh, hd)
            out = ops.chunked_prefill_attention(
                q, kg, vg, positions, kv_pos, window=0,
                use_kernels=self.use_kernels)
            x = self._attn_out(i, x, out)
        return x

    def _decode_fwd(self, tokens, positions, write_idx, tables, ctx_lens):
        """tokens/positions/write_idx [Bb]; tables [Bb, Pb] (trash-padded);
        ctx_lens [Bb] (0 for padded lanes). Returns final hidden states."""
        cfg = self.cfg
        lp = self.params["layers"]
        x = self.params["embed"][tokens][:, None]
        pos2 = positions[:, None]
        for i in range(self.model.n_stack):
            hx = rmsnorm(x, lp["ln1"][i], cfg.norm_eps)
            q, k, v = self._qkv(i, hx, pos2)
            kp, vp = self.k_pool[i], self.v_pool[i]
            self._write(kp, k[:, 0], write_idx)
            self._write(vp, v[:, 0], write_idx)
            out = ops.paged_decode_attention(
                q[:, 0], kp, vp, tables, ctx_lens,
                use_kernels=self.use_kernels)
            x = self._attn_out(i, x, out[:, None])
        return x[:, 0]

    # ------------------------------------------------------------------
    # executor interface
    # ------------------------------------------------------------------
    def _flat_idx(self, table, pos: int) -> int:
        return table[pos // self.page] * self.page + pos % self.page

    @torch.no_grad()
    def prefill_chunk(self, slot: int, tokens: np.ndarray, ctx_len: int,
                      completes: bool, enc_emb=None) -> Optional[int]:
        """Run one prefill chunk for ``slot`` through the request's block
        table. Returns the first output token if the prompt completes."""
        table = self._alloc().block_table(self._req_id(slot))
        page = self.page
        c = len(tokens)
        total = ctx_len + c
        cb = self.buckets.bucket(c, lo=16)
        pb = self.buckets.bucket(math.ceil(total / page), lo=4)
        assert len(table) * page >= total, "block table behind context"

        tok = np.zeros((1, cb), np.int32)
        tok[0, :c] = tokens
        pos = np.full((1, cb), -1, np.int32)
        pos[0, :c] = ctx_len + np.arange(c)
        widx = np.full((cb,), self._trash * page, np.int64)
        for j in range(c):
            widx[j] = self._flat_idx(table, ctx_len + j)
        tbl = np.full((pb,), self._trash, np.int64)
        take = min(len(table), pb)
        tbl[:take] = table[:take]

        self.buckets.record("prefill", cb, pb)
        x = self._prefill_fwd(self._tensor(tok, torch.long),
                              self._tensor(pos), self._tensor(widx, torch.long),
                              self._tensor(tbl, torch.long), total)
        if not completes:
            return None
        # only the last prompt token's logits are read
        self.last_logits = self._finish(x[:, c - 1]).float().cpu().numpy()
        return robust_greedy(self.last_logits[0])

    @torch.no_grad()
    def decode(self, slot_tokens: Dict[int, int],
               slot_lens: Dict[int, int]) -> Dict[int, int]:
        """One decode step over the active slots' block tables."""
        alloc = self._alloc()
        page = self.page
        slots = sorted(slot_tokens)
        tables = [alloc.block_table(self._req_id(s)) for s in slots]
        n = len(slots)
        bb = self.buckets.bucket(n, lo=4)
        pb = self.buckets.bucket(
            max(math.ceil((slot_lens[s] + 1) / page) for s in slots), lo=4)

        tok = np.zeros((bb,), np.int64)
        pos = np.zeros((bb,), np.int32)
        widx = np.full((bb,), self._trash * page, np.int64)
        tbl = np.full((bb, pb), self._trash, np.int32)
        ctx = np.zeros((bb,), np.int32)
        for i, s in enumerate(slots):
            p = slot_lens[s]
            tok[i] = slot_tokens[s]
            pos[i] = p
            widx[i] = self._flat_idx(tables[i], p)
            take = min(len(tables[i]), pb)
            tbl[i, :take] = tables[i][:take]
            ctx[i] = p + 1

        self.buckets.record("decode", bb, pb)
        x = self._decode_fwd(self._tensor(tok, torch.long), self._tensor(pos),
                             self._tensor(widx, torch.long),
                             self._tensor(tbl), self._tensor(ctx))
        # one [n, V] block to the host per step
        self.last_logits = self._finish(x[:n]).float().cpu().numpy()
        return {s: robust_greedy(self.last_logits[i])
                for i, s in enumerate(slots)}

    # ------------------------------------------------------------------
    # KV handoff: block-granular, sized by the partial prefill
    # ------------------------------------------------------------------
    def extract_kv(self, slot: int, upto: int):
        """PPI->CPI payload: only the ``ceil(upto / page)`` blocks covering
        the partial prefill travel. The payload is a copy on the device
        (indexing with a tensor copies): the PPI frees and reuses these
        blocks before the simulated transfer delivers it."""
        table = self._alloc().block_table(self._req_id(slot))
        nblk = math.ceil(upto / self.page)
        idx = torch.as_tensor(np.asarray(table[:nblk], np.int64),
                              device=self.device)
        return {"k_pages": self.k_pool[:, idx],
                "v_pages": self.v_pool[:, idx],
                "_upto": upto, "_page": self.page}

    @torch.no_grad()
    def inject_kv(self, slot: int, payload, upto: int):
        """Scatter a transferred payload into the blocks this engine's
        allocator assigned, in place and on the device. Positions the
        local prefix cache already covers (``allocator.shared_tokens``)
        are skipped: shared blocks are immutable, and their content is
        already resident."""
        alloc = self._alloc()
        assert payload["_page"] == self.page, \
            "page-size mismatch across a paged handoff"
        req_id = self._req_id(slot)
        table = alloc.block_table(req_id)
        shared = (alloc.shared_tokens(req_id)
                  if hasattr(alloc, "shared_tokens") else 0)
        p_upto = int(payload["_upto"])
        start = min(shared, p_upto)
        n = p_upto - start
        if n <= 0:
            return
        l_dim, kvh, hd = (self.k_pool.shape[0], self.k_pool.shape[3],
                          self.k_pool.shape[4])
        dst = torch.as_tensor(
            np.asarray([self._flat_idx(table, start + j) for j in range(n)],
                       np.int64), device=self.device)
        self.buckets.record("inject", self.buckets.bucket(n, lo=self.page))
        for pool, key in ((self.k_pool, "k_pages"), (self.v_pool, "v_pages")):
            src = payload[key].reshape(l_dim, -1, kvh, hd)[:, start:p_upto]
            pool.view(l_dim, -1, kvh, hd).index_copy_(
                1, dst, src.to(device=self.device, dtype=pool.dtype))

    def reset_slot(self, slot: int):
        """Nothing to scrub: validity lives in the allocator's tables and
        per-request context lengths, not in pool contents."""
