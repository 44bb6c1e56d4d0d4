"""Paged-KV block allocator (host-side bookkeeping, vLLM-style).

The Balancer (paper Alg. 1) gates admission on ``N_free < ceil(L_in / N_size)``
— this allocator is the source of truth for that check. The functional
engine allocates blocks per request as its context grows; the Pallas
paged-attention kernel consumes the same block tables on TPU.

Prefix caching (``prefix_cache=True``, default off — the off path is
bit-identical to the plain allocator):

  * every block carries a refcount; blocks of a finished request whose
    content is registered in the prefix index are RETAINED at refcount 0
    in an LRU list instead of returning to the free list;
  * the index is a hash-of-token-ids chain (vLLM-style): block ``i`` of a
    sequence hashes ``(parent_chain_hash, token_ids[i*bs:(i+1)*bs])``, so
    ``lookup_prefix`` walks full blocks hash-by-hash and ``share_blocks``
    bumps their refcounts into a new request's block table;
  * on partial-block divergence (the request's tokens leave a cached
    block's content mid-block, or the match is capped mid-block) the
    request takes a private copy-on-write block covering the common
    prefix — shared blocks are immutable, so nobody's view corrupts;
  * cached refcount-0 blocks are *evictable*: ``num_free`` counts them,
    which keeps the free-block signal the Balancer reads honest (a cached
    block never blocks admission — allocation evicts LRU-first on demand).

Host-memory tier (``host_blocks > 0``, requires ``prefix_cache``): when a
cached refcount-0 block is evicted to satisfy an allocation, its indexed
content is *demoted* to a modeled CPU-DRAM tier (an LRU of up to
``host_blocks`` entries keyed by chain hash) instead of being dropped.
The prefix walk crosses tiers transparently, so ``lookup_prefix`` still
sees demoted chains and ``share_blocks`` *promotes* matched host entries
back into GPU blocks on placement. Tier moves are charged as PCIe traffic:
the allocator accumulates moved tokens and the engine drains them via
:meth:`take_pending_host_transfer_tokens` into the iteration's overlap
budget (``DeviceModel.host_kv_time``). ``num_free`` never counts host
entries — the Balancer's Algorithm-1 signal stays a GPU-pool truth — and
executors with physical pools mirror the moves through the ``on_demote``
/ ``on_promote`` / ``on_host_evict`` hooks.
"""
from __future__ import annotations

import hashlib
import math
from collections import OrderedDict
from typing import Dict, List, Optional

import numpy as np


def _chain(parent: bytes, tokens: np.ndarray) -> bytes:
    """Chained content hash of one block: parent digest + token ids."""
    return hashlib.blake2b(parent + np.ascontiguousarray(tokens).tobytes(),
                           digest_size=16).digest()


def _common_prefix_len(a: np.ndarray, b: np.ndarray) -> int:
    m = min(len(a), len(b))
    if m == 0:
        return 0
    eq = a[:m] == b[:m]
    return m if eq.all() else int(np.argmax(~eq))


class BlockAllocator:
    """Paged-KV block accounting for one engine: free list, per-request
    block tables, optional refcounted prefix cache, and an optional
    host-memory ("CPU") tier that demoted cache blocks spill into."""

    def __init__(self, num_blocks: int, block_size: int,
                 prefix_cache: bool = False, host_blocks: int = 0):
        self.num_blocks = num_blocks
        self.block_size = block_size
        self.prefix_cache = prefix_cache
        self.host_blocks = int(host_blocks)
        if self.host_blocks and not prefix_cache:
            raise ValueError("host_blocks requires prefix_cache: the host "
                             "tier holds demoted prefix-cache content")
        self._free: List[int] = list(range(num_blocks - 1, -1, -1))
        self._owned: Dict[str, List[int]] = {}
        # Physical-copy hook for executors that keep real KV behind these
        # block ids (PagedRealExecutor). Called as ``on_cow(dst, src,
        # n_tokens)`` when a copy-on-write block is taken so the backend
        # can clone the first ``n_tokens`` rows of ``src`` into ``dst``.
        # Simulation-only engines leave it None.
        self.on_cow = None
        self._shared: Dict[str, int] = {}         # req -> cache-shared tokens
        # --- prefix-cache state (all empty when prefix_cache is off) ----
        self._ref: Dict[int, int] = {}            # block -> live refcount
        self._lru: OrderedDict = OrderedDict()    # refcount-0 cached blocks
        self._block_hash: Dict[int, bytes] = {}   # indexed block -> chain hash
        self._hash_to_block: Dict[bytes, int] = {}
        self._block_parent: Dict[int, bytes] = {}
        self._block_tokens: Dict[int, np.ndarray] = {}
        self._children: Dict[bytes, List[int]] = {}
        # --- host-memory tier (empty when host_blocks == 0) -------------
        # chain hash -> (parent chain hash, block tokens); LRU order.
        # Disjoint from the GPU index by invariant: a hash lives in
        # ``_hash_to_block`` or ``_host``, never both.
        self._host: "OrderedDict[bytes, tuple]" = OrderedDict()
        # Physical-move hooks, mirroring ``on_cow``: ``on_demote(block,
        # key)`` fires while the demoted block's pool row is still intact
        # (save it host-side), ``on_promote(block, key)`` after a GPU
        # block was taken for the promoted content (restore the row), and
        # ``on_host_evict(key)`` when a host entry is dropped.
        self.on_demote = None
        self.on_promote = None
        self.on_host_evict = None
        # flight recorder back-reference: the allocator has no clock of
        # its own, so InferenceService.start_trace points this at the
        # owning engine (clock + tracer + track). None = zero overhead.
        self.trace_engine = None
        self._pending_host_tokens = 0   # PCIe traffic awaiting charge
        # counters (benchmark / metrics surface)
        self.n_prefix_hits = 0      # share_blocks calls that reused tokens
        self.n_tokens_reused = 0    # prompt tokens whose prefill was skipped
        self.n_cow_copies = 0       # partial-block divergence copies
        self.n_evictions = 0        # cached blocks reclaimed for allocation
        self.n_demotions = 0        # blocks spilled GPU -> host tier
        self.n_promotions = 0       # host entries pulled back into GPU blocks
        self.n_host_evictions = 0   # host entries dropped (capacity/collision)

    @property
    def num_free(self) -> int:
        """Blocks available to allocate. Cached refcount-0 blocks count:
        they are reclaimed LRU-first on demand, so the Balancer's
        Algorithm-1 admission signal must treat them as free."""
        return len(self._free) + len(self._lru)

    def blocks_needed(self, n_tokens: int) -> int:
        """Blocks covering ``n_tokens`` at this block size."""
        return math.ceil(n_tokens / self.block_size)

    def can_allocate(self, n_tokens: int) -> bool:
        """Whether a fresh ``n_tokens`` allocation would fit right now."""
        return self.blocks_needed(n_tokens) <= self.num_free

    # ------------------------------------------------------------------
    # block supply (free list first, then LRU eviction of cached blocks)
    # ------------------------------------------------------------------
    def _evict_lru(self, exclude: Optional[int] = None) -> None:
        for b in self._lru:
            if b != exclude:
                if self.host_blocks:
                    self._demote(b)
                else:
                    self._deindex(b)
                self._free.append(b)
                self.n_evictions += 1
                return
        raise MemoryError("no evictable cached block")

    def _demote(self, b: int) -> None:
        """Spill an evicted cache block's content to the host tier. Partial
        tail blocks are dropped instead: the cross-tier walk matches full
        blocks only, so a demoted partial could never be promoted back."""
        h = self._block_hash[b]
        parent = self._block_parent[b]
        tokens = self._block_tokens[b]
        self._deindex(b)
        if len(tokens) < self.block_size:
            return
        self._host[h] = (parent, tokens)          # MRU end
        self.n_demotions += 1
        self._pending_host_tokens += len(tokens)
        eng = self.trace_engine
        if eng is not None and eng.tracer is not None:
            eng.tracer.instant(eng.trace_track, "kv_demote", eng.clock,
                               {"tokens": len(tokens)})
        if self.on_demote is not None:
            self.on_demote(b, h)
        while len(self._host) > self.host_blocks:
            k, _ = self._host.popitem(last=False)  # oldest entry
            self.n_host_evictions += 1
            if self.on_host_evict is not None:
                self.on_host_evict(k)

    def _promote(self, key: bytes) -> int:
        """Pull one host-tier entry back into a freshly taken GPU block
        (caller guarantees ``num_free >= 1``) and re-register it in the
        prefix index at refcount 1."""
        parent, tokens = self._host.pop(key)
        blk = self._take_block()
        self._block_hash[blk] = key
        self._hash_to_block[key] = blk
        self._block_parent[blk] = parent
        self._block_tokens[blk] = tokens
        self._children.setdefault(parent, []).append(blk)
        self._ref[blk] = 1
        self.n_promotions += 1
        self._pending_host_tokens += len(tokens)
        eng = self.trace_engine
        if eng is not None and eng.tracer is not None:
            eng.tracer.instant(eng.trace_track, "kv_promote", eng.clock,
                               {"tokens": len(tokens)})
        if self.on_promote is not None:
            self.on_promote(blk, key)
        return blk

    def take_pending_host_transfer_tokens(self) -> int:
        """Drain the tokens moved across PCIe (demotions + promotions)
        since the last call — the engine charges them into the current
        iteration's transfer-overlap budget."""
        n, self._pending_host_tokens = self._pending_host_tokens, 0
        return n

    @property
    def host_resident_blocks(self) -> int:
        """Entries currently held in the host-memory tier."""
        return len(self._host)

    def _deindex(self, b: int) -> None:
        """Drop a block from the prefix index (eviction). Indexed
        descendants keyed under its chain hash become unreachable to the
        walk and simply age out of the LRU."""
        self._lru.pop(b, None)
        h = self._block_hash.pop(b)
        del self._hash_to_block[h]
        parent = self._block_parent.pop(b)
        self._block_tokens.pop(b)
        sibs = self._children[parent]
        sibs.remove(b)
        if not sibs:
            del self._children[parent]

    def _take_block(self, exclude: Optional[int] = None) -> int:
        if not self._free:
            self._evict_lru(exclude)
        return self._free.pop()

    def allocate(self, req_id: str, n_tokens: int) -> List[int]:
        """Give ``req_id`` fresh blocks for ``n_tokens`` (MemoryError if
        the pool, including reclaimable cache, cannot cover it)."""
        need = self.blocks_needed(n_tokens)
        if need > self.num_free:
            raise MemoryError(f"out of KV blocks: need {need}, free {self.num_free}")
        blocks = [self._take_block() for _ in range(need)]
        if self.prefix_cache:
            for b in blocks:
                self._ref[b] = 1
        self._owned.setdefault(req_id, []).extend(blocks)
        return blocks

    def owned_blocks(self, req_id: str) -> int:
        """Blocks currently held by a request (0 if unknown)."""
        return len(self._owned.get(req_id, ()))

    def can_extend_to(self, req_id: str, n_tokens: int) -> bool:
        """Whether growing ``req_id`` to ``n_tokens`` total would fit."""
        return (self.blocks_needed(n_tokens) - self.owned_blocks(req_id)
                <= self.num_free)

    def extend_to(self, req_id: str, n_tokens: int) -> List[int]:
        """Grow a request's allocation until it covers ``n_tokens`` total
        (no-op if it already does). This is the dynamic-growth entry point
        the iteration scheduler uses as ``context_len`` advances."""
        have = self.owned_blocks(req_id)
        extra = max(0, self.blocks_needed(n_tokens) - have)
        if extra > self.num_free:
            raise MemoryError(
                f"out of KV blocks: need {extra}, free {self.num_free}")
        blocks = [self._take_block() for _ in range(extra)]
        if blocks:
            if self.prefix_cache:
                for b in blocks:
                    self._ref[b] = 1
            self._owned.setdefault(req_id, []).extend(blocks)
        return blocks

    def free(self, req_id: str,
             cache_tokens: Optional[np.ndarray] = None) -> None:
        """Release a request's blocks. With prefix caching, pass the token
        ids the blocks hold (prompt + generated) to register their content
        in the prefix index before the refcounts drop: refcount-0 indexed
        blocks are retained in the LRU cache, everything else returns to
        the free list. Without ``cache_tokens`` (preemption, or caching
        off) nothing is registered."""
        blocks = self._owned.pop(req_id, [])
        self._shared.pop(req_id, None)
        if not self.prefix_cache:
            self._free.extend(blocks)
            return
        if cache_tokens is not None and blocks:
            self._register(blocks, np.asarray(cache_tokens, np.int32))
        for b in blocks:
            self._ref[b] -= 1
            if self._ref[b] == 0:
                del self._ref[b]
                if b in self._block_hash:
                    self._lru[b] = None           # retained, MRU end
                else:
                    self._free.append(b)

    # ------------------------------------------------------------------
    # prefix index
    # ------------------------------------------------------------------
    def _register(self, blocks: List[int], tokens: np.ndarray) -> None:
        """Index each block of a released sequence under its chain hash
        (full blocks, plus the partial tail — divergence from a partial
        block is served by copy-on-write). First registration of a given
        content wins; a block whose hash is already mapped elsewhere stays
        unindexed and frees normally."""
        h = b""
        for i, blk in enumerate(blocks):
            lo = i * self.block_size
            hi = min(lo + self.block_size, len(tokens))
            if hi <= lo:
                break
            parent, h = h, _chain(h, tokens[lo:hi])
            if blk in self._block_hash:
                continue            # already indexed (shared prefix block)
            if h in self._hash_to_block:
                continue            # duplicate content; existing entry wins
            if h in self._host:
                # the content just re-materialized on the GPU: keep the
                # tiers disjoint — the fresh GPU copy is authoritative
                del self._host[h]
                self.n_host_evictions += 1
                if self.on_host_evict is not None:
                    self.on_host_evict(h)
            self._block_hash[blk] = h
            self._hash_to_block[h] = blk
            self._block_parent[blk] = parent
            self._block_tokens[blk] = tokens[lo:hi].copy()
            self._children.setdefault(parent, []).append(blk)

    def _match_prefix(self, tokens: np.ndarray, max_tokens: Optional[int]):
        """The single source of truth both ``lookup_prefix`` (read-only
        promise) and ``share_blocks`` (placement) use: walk the full-block
        hash chain — crossing into the host tier wherever a link was
        demoted — then find the best common prefix into one GPU-cached
        block past the divergence point. Returns ``(keys, n_full, src,
        src_len)`` — the matched chain hashes (each resolvable in exactly
        one tier), the tokens they cover, and the CoW source block (with
        its matched token count), if any."""
        tokens = np.asarray(tokens, np.int32)
        limit = len(tokens) if max_tokens is None else min(max_tokens,
                                                           len(tokens))
        keys: List[bytes] = []
        n, h = 0, b""
        while n + self.block_size <= limit:
            h2 = _chain(h, tokens[n:n + self.block_size])
            if h2 not in self._hash_to_block and h2 not in self._host:
                break
            keys.append(h2)
            n, h = n + self.block_size, h2
        src, src_len = None, 0
        for b in self._children.get(h, ()):
            k = _common_prefix_len(tokens[n:limit], self._block_tokens[b])
            if k > src_len:
                src, src_len = b, k
        return keys, n, src, src_len

    def lookup_prefix(self, tokens: np.ndarray,
                      max_tokens: Optional[int] = None) -> int:
        """Tokens of ``tokens`` whose KV is reusable from the cache right
        now — either tier: the longest full-block hash-chain match (host
        links count; they promote at share time), plus the longest common
        prefix into one cached block past it (served by CoW at share
        time). Read-only — used by planners and affinity routers."""
        if not self.prefix_cache:
            return 0
        _, n, _, src_len = self._match_prefix(tokens, max_tokens)
        return n + src_len

    def share_blocks(self, req_id: str, tokens: np.ndarray,
                     max_tokens: Optional[int] = None) -> int:
        """Seed a new request's block table from the prefix cache: bump
        refcounts on every fully-matched block, and on partial-block
        divergence take a copy-on-write block holding the common prefix
        (skipped when no block is available for the copy). Returns the
        number of prompt tokens whose prefill is thereby skipped. Must be
        called before the request owns any blocks."""
        if not self.prefix_cache:
            return 0
        assert not self._owned.get(req_id), "share_blocks before allocate"
        keys, n, src, src_len = self._match_prefix(tokens, max_tokens)
        table: List[int] = []
        n = 0
        for key in keys:
            # resolve each link live: a promotion below may have evicted
            # (or itself demoted) blocks matched further along the chain
            blk = self._hash_to_block.get(key)
            if blk is not None:
                if blk not in self._ref:
                    self._lru.pop(blk)            # resurrect from cache
                    self._ref[blk] = 0
                self._ref[blk] += 1
            elif key in self._host and self.num_free >= 1:
                blk = self._promote(key)
            else:
                # chain broken mid-walk (host entry displaced, or no GPU
                # block left to promote into): keep the contiguous prefix
                src, src_len = None, 0
                break
            table.append(blk)
            n += self.block_size
        if src is not None and src_len > 0:
            # partial-block divergence -> copy-on-write; the promote pass
            # can displace cached blocks, so re-check src is still indexed
            spare = self.num_free - (1 if src in self._lru else 0)
            if spare >= 1 and src in self._block_tokens:
                cow = self._take_block(exclude=src)
                if self.on_cow is not None:
                    self.on_cow(cow, src, src_len)
                self._ref[cow] = 1
                table.append(cow)
                n += src_len
                self.n_cow_copies += 1
        if table:
            self._owned[req_id] = table
        if n > 0:
            self.n_prefix_hits += 1
            self.n_tokens_reused += n
            self._shared[req_id] = n
        return n

    def shared_tokens(self, req_id: str) -> int:
        """Tokens at the head of ``req_id``'s context that came from the
        prefix cache via :meth:`share_blocks`. Block-pool executors must
        not overwrite them on inject: the full-block share is immutable
        shared storage, and the CoW tail was already cloned physically."""
        return self._shared.get(req_id, 0)

    def adopt_prefix(self, tokens: np.ndarray, n_tokens: int) -> int:
        """Replicate the first ``n_tokens`` of ``tokens`` into this cache
        as refcount-0 retained blocks — the receiving half of a
        cross-endpoint prefix fetch (the content arrived from a peer's
        pool via the transfer engine; link cost is charged by the caller).
        Full blocks only; links already resident (either tier) are touched
        to MRU instead of duplicated. Returns the tokens *newly
        materialized* here (0 when caching is off or the pool is fully
        owned)."""
        if not self.prefix_cache:
            return 0
        tokens = np.asarray(tokens, np.int32)
        limit = min(int(n_tokens), len(tokens))
        n, h, adopted = 0, b"", 0
        while n + self.block_size <= limit:
            h2 = _chain(h, tokens[n:n + self.block_size])
            if h2 in self._hash_to_block:
                blk = self._hash_to_block[h2]
                if blk in self._lru:
                    self._lru.move_to_end(blk)    # fetched prefix is hot
            elif h2 in self._host:
                self._host.move_to_end(h2)
            else:
                if self.num_free < 1:
                    break
                blk = self._take_block()
                self._block_hash[blk] = h2
                self._hash_to_block[h2] = blk
                self._block_parent[blk] = h
                self._block_tokens[blk] = tokens[n:n + self.block_size].copy()
                self._children.setdefault(h, []).append(blk)
                self._lru[blk] = None             # refcount-0, evictable
                adopted += self.block_size
            n, h = n + self.block_size, h2
        return adopted

    def block_table(self, req_id: str) -> List[int]:
        """The request's current block table (copy), in context order."""
        return list(self._owned.get(req_id, []))

    def check_invariants(self) -> None:
        """Assert the full partition/accounting story; tests call this
        after every scenario. Covers both tiers when a host tier is on."""
        owned = [b for bs in self._owned.values() for b in bs]
        if not self.prefix_cache:
            assert len(owned) == len(set(owned)), "double-allocated block"
            assert len(owned) + len(self._free) == self.num_blocks, \
                "leaked blocks"
            assert not (set(owned) & set(self._free)), \
                "block both owned and free"
            return
        # refcount-consistent accounting: every block is exactly one of
        # owned (ref >= 1), cached (ref 0, indexed, in LRU), or free
        for bs in self._owned.values():
            assert len(bs) == len(set(bs)), "block twice in one table"
        counts: Dict[int, int] = {}
        for b in owned:
            counts[b] = counts.get(b, 0) + 1
        assert counts == self._ref, \
            f"refcounts disagree with block tables: {counts} vs {self._ref}"
        owned_set, lru_set, free_set = (set(counts), set(self._lru),
                                        set(self._free))
        assert not owned_set & lru_set, "owned block in LRU cache"
        assert not owned_set & free_set, "block both owned and free"
        assert not lru_set & free_set, "block both cached and free"
        assert len(owned_set | lru_set | free_set) == self.num_blocks, \
            "leaked blocks"
        for b in lru_set:
            assert b in self._block_hash, "unindexed block retained in LRU"
        assert set(self._block_hash) == set(self._hash_to_block.values())
        for b, h in self._block_hash.items():
            assert self._hash_to_block[h] == b, "index maps disagree"
            assert b in self._block_tokens and b in self._block_parent
            assert b in self._children[self._block_parent[b]]
        # --- host-tier accounting ---------------------------------------
        if not self.host_blocks:
            assert not self._host, "host entries with the tier disabled"
            return
        assert len(self._host) <= self.host_blocks, "host tier over capacity"
        assert not (set(self._host) & set(self._hash_to_block)), \
            "chain hash resident in both tiers"
        for k, (parent, toks) in self._host.items():
            assert len(toks) == self.block_size, \
                "partial block demoted to host tier"
