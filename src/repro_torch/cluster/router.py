"""Pluggable request routers for the cluster runtime.

A router picks, for each arriving request, which endpoint (Cronus pair /
DP worker / disaggregated pool) serves it. ``select`` returns ``None``
when the chosen endpoint cannot take the request yet — the runtime then
retries after engines advance (head-of-line order, matching the dispatch
discipline of the per-system loops this subsystem replaced).

Policies:
  * :class:`RoundRobinRouter` — optionally weighted (paper §5.1's DP
    baseline uses weights 3:1 for A100:A10); probes endpoints in pattern
    order starting after the previous placement.
  * :class:`LeastLoadedRouter` — smallest queue depth first, most free KV
    blocks (via ``Engine.stats``) as the tie-break, so an empty cluster
    routes to the endpoint with the deepest free KV pool.
  * :class:`SessionAffinityRouter` — requests carrying a ``session`` stick
    to the endpoint that served the session first (KV reuse locality for
    multi-turn conversations); session-less requests and first turns fall
    through to an inner policy (least-loaded by default). A pin is not
    eternal: a home endpoint that keeps rejecting, or that is drastically
    more loaded than the best alternative, triggers a rebalance (the
    session re-pins through the fallback policy).
  * :class:`PrefixAffinityRouter` — routes each request to the endpoint
    holding the longest cached prefix of its prompt (live engine probe
    via ``Endpoint.cached_prefix_tokens``, backed by the router's own
    routing history), so shared system prompts and multi-turn sessions
    concentrate where their KV already lives; cache-cold requests fall
    through to least-loaded, and a load guard keeps affinity from
    convoying a hot endpoint.
  * :class:`KVAwareRouter` — cluster-level prefix *content* index: one
    global chain-hash map of which endpoints hold which prefix blocks
    (GPU or host tier), strengthened by the live allocator probe, with
    an optional cross-endpoint prefix fetch through the cluster
    transfer engine when load forces a request away from its KV.
"""
from __future__ import annotations

import abc
from collections import OrderedDict
from typing import List, Optional, Sequence

from repro_torch.cluster.runtime import Endpoint
from repro_torch.core.request import Request
from repro_torch.kvcache.allocator import _chain


class Router(abc.ABC):
    """Routing policy: pick an endpoint for each dispatched request."""

    @abc.abstractmethod
    def select(self, req: Request,
               endpoints: Sequence[Endpoint]) -> Optional[Endpoint]:
        """Endpoint to serve ``req``, or ``None`` to retry later."""

    def on_membership_change(self, endpoints: Sequence[Endpoint]) -> None:
        """The cluster attached or detached an endpoint (elastic
        autoscaling): drop or remap any per-endpoint routing state so the
        next ``select`` neither KeyErrors nor routes to a ghost. Stateless
        routers need nothing; the default is a no-op."""


class RoundRobinRouter(Router):
    """Rotate over the endpoints, optionally weighted (dp's pattern)."""

    def __init__(self, weights: Optional[List[int]] = None):
        self.weights = weights
        self._pattern: Optional[List[int]] = None
        self._idx = 0

    def _pat(self, n: int) -> List[int]:
        if self._pattern is None:
            w = self.weights or [1] * n
            if len(w) != n:
                raise ValueError(f"{len(w)} weights for {n} endpoints")
            self._pattern = [i for i, wi in enumerate(w) for _ in range(wi)]
        return self._pattern

    def select(self, req, endpoints):
        """Next accepting endpoint in the (weighted) rotation."""
        pat = self._pat(len(endpoints))
        for probe in range(len(pat)):
            ep = endpoints[pat[(self._idx + probe) % len(pat)]]
            if ep.can_accept(req):
                self._idx = (self._idx + probe + 1) % len(pat)
                return ep
        return None

    def on_membership_change(self, endpoints):
        """Rebuild the rotation for the new fleet size."""
        # the pattern is positional, so it must be rebuilt for the new
        # membership; explicit weights were given for a specific fleet
        # size and cannot be remapped onto a different one — degrade to
        # uniform rotation rather than raising on the next select
        self._pattern = None
        self._idx = 0
        if self.weights is not None and len(self.weights) != len(endpoints):
            self.weights = None


class LeastLoadedRouter(Router):
    """Shallowest queue first; ties broken by free KV, then position."""

    def select(self, req, endpoints):
        """Accepting endpoint with the shallowest queue."""
        best, best_key = None, None
        for i, ep in enumerate(endpoints):
            if not ep.can_accept(req):
                continue
            s = ep.stats()
            key = (s.queue_depth, -s.free_kv_blocks, i)
            if best_key is None or key < best_key:
                best, best_key = ep, key
        return best


class SessionAffinityRouter(Router):
    """Pin each conversation (``req.session``) to one endpoint for KV
    locality, rebalancing via the fallback when the home endpoint stalls
    or runs ``imbalance``x deeper than the best alternative."""

    # a sticky head whose home endpoint is full returns None; let the
    # runtime place up to this many queued requests past it so one pinned
    # session doesn't convoy the whole arrival queue
    lookahead = 64

    def __init__(self, fallback: Optional[Router] = None,
                 max_stalls: int = 4, imbalance: float = 8.0):
        self.fallback = fallback or LeastLoadedRouter()
        self.max_stalls = max_stalls   # consecutive home rejections tolerated
        self.imbalance = imbalance     # home queue depth vs best alternative
        self._table = {}   # session id -> endpoint
        self._stalls = {}  # session id -> consecutive deferred selects

    def _overloaded(self, home, req, endpoints) -> bool:
        """Staleness escape hatch: a pin is worth KV locality only while
        the home endpoint is roughly competitive. If its queue runs
        ``imbalance``x deeper than the best alternative that would take
        the request, migrating (and re-prefilling) beats waiting."""
        others = [ep.stats().queue_depth for ep in endpoints
                  if ep is not home and ep.can_accept(req)]
        if not others:
            return False
        return home.stats().queue_depth > self.imbalance * (min(others) + 1)

    def select(self, req, endpoints):
        """The session's home endpoint, or a fresh pin via the fallback."""
        sess = getattr(req, "session", None)
        if sess is not None and sess in self._table:
            ep = self._table[sess]
            if ep.can_accept(req) and not self._overloaded(ep, req,
                                                           endpoints):
                self._stalls.pop(sess, None)
                return ep
            # home endpoint full or overloaded: tolerate a few stalls for
            # KV locality, then rebalance the session via the fallback
            # (the old behaviour pinned forever, convoying the session
            # behind the one most-loaded endpoint)
            stalls = self._stalls.get(sess, 0) + 1
            self._stalls[sess] = stalls
            if stalls <= self.max_stalls and not self._overloaded(
                    ep, req, endpoints):
                return None
        ep = self.fallback.select(req, endpoints)
        if ep is not None and sess is not None:
            self._table[sess] = ep
            self._stalls.pop(sess, None)
        return ep

    def on_membership_change(self, endpoints):
        """Un-home sessions whose endpoint left the cluster."""
        # un-home sessions whose endpoint left the cluster: they re-pin
        # through the fallback on their next request instead of sticking
        # to (and stalling on) a ghost endpoint
        live = set(map(id, endpoints))
        dead = [s for s, ep in self._table.items() if id(ep) not in live]
        for s in dead:
            del self._table[s]
            self._stalls.pop(s, None)
        self.fallback.on_membership_change(endpoints)


class PrefixAffinityRouter(Router):
    """Route toward the endpoint holding the longest cached prefix of the
    request's prompt (vLLM-production-stack-style prefix-aware routing);
    cache-cold requests fall back to least-loaded.

    Two affinity signals, the stronger wins:

      * the *live probe* — ``Endpoint.cached_prefix_tokens`` walks each
        endpoint's actual prefix index (exact, but blind to requests the
        runtime dispatched ahead of the simulated clock, whose KV is not
        cached yet);
      * *routing history* — block-grained chain hashes of every prompt
        this router placed, kept per endpoint (the production-stack
        trick: the router's own record of where a prefix went predicts
        where its KV lives, without asking the engines).

    ``min_match`` ignores trivially short matches that aren't worth
    skewing load for, and ``max_imbalance`` caps how much deeper than the
    least-loaded alternative the matched endpoint's queue may run — a hit
    saves one prefix prefill, not an unbounded wait behind a hot spot."""

    def __init__(self, fallback: Optional[Router] = None,
                 min_match: int = 16, max_imbalance: int = 4,
                 history_per_endpoint: int = 8192):
        self.fallback = fallback or LeastLoadedRouter()
        self.min_match = min_match
        self.max_imbalance = max_imbalance
        self.history_per_endpoint = history_per_endpoint
        # keyed by endpoint NAME, not list position: positions shift when
        # the cluster attaches/detaches endpoints (elastic autoscaling),
        # and a positional table would silently credit one endpoint with
        # another's routing history
        self._history: Dict[str, OrderedDict] = {}   # name -> hash -> True

    def _prompt_hashes(self, req, block_size: int) -> List[bytes]:
        hashes, h = [], b""
        prompt = req.prompt
        for lo in range(0, len(prompt) - block_size + 1, block_size):
            h = _chain(h, prompt[lo:lo + block_size])
            hashes.append(h)
        return hashes

    def _history_match(self, name: str, hashes: List[bytes],
                      block_size: int) -> int:
        seen = self._history.get(name)
        if seen is None:
            return 0
        n = 0
        for h in hashes:
            if h not in seen:
                break
            n += block_size
        return n

    def _record(self, name: str, hashes: List[bytes]):
        seen = self._history.setdefault(name, OrderedDict())
        for h in hashes:
            seen.pop(h, None)
            seen[h] = True                       # re-insert at MRU end
        while len(seen) > self.history_per_endpoint:
            seen.popitem(last=False)

    def select(self, req, endpoints):
        """Longest-cached-prefix endpoint, under the load guard."""
        bs = endpoints[0].engines[-1].ecfg.block_size
        hashes = self._prompt_hashes(req, bs)
        cands = [ep for ep in endpoints if ep.can_accept(req)]
        if not cands:
            return None
        best, best_len = None, self.min_match - 1
        for ep in cands:
            n = max(ep.cached_prefix_tokens(req),
                    self._history_match(ep.name, hashes, bs))
            if n > best_len:
                best, best_len = ep, n
        if best is not None:
            # affinity is only worth the skew while the matched endpoint
            # is roughly competitive on load
            floor = min(ep.stats().queue_depth for ep in cands)
            if best.stats().queue_depth <= floor + self.max_imbalance:
                self._record(best.name, hashes)
                return best
        ep = self.fallback.select(req, endpoints)
        if ep is not None:
            self._record(ep.name, hashes)
        return ep

    def on_membership_change(self, endpoints):
        """Forget detached endpoints' routing histories."""
        # forget detached endpoints' histories (their KV left with them);
        # a re-attached name starts cold, which is exactly its cache state
        live = {ep.name for ep in endpoints}
        for name in [n for n in self._history if n not in live]:
            del self._history[name]
        self.fallback.on_membership_change(endpoints)


class KVAwareRouter(Router):
    """Cluster-level prefix index: route each request to the endpoint
    whose KV caches — GPU *or* host tier — hold the longest prefix of its
    prompt (Mooncake/Dynamo-style KV-aware scheduling).

    Where :class:`PrefixAffinityRouter` keeps a per-endpoint *routing
    history* (where prompts were sent), this router maintains one global
    chain-hash index of where prefix *content* lives, updated on every
    placement — so two endpoints that both hold a hot prefix are both
    credited, and eviction-driven staleness is bounded by the live probe
    (``Endpoint.cached_prefix_tokens`` walks the real allocator indexes,
    including host-demoted chains) taken as the stronger of the two
    signals.

    Optionally (``fetch=True``) a routed-away request triggers a
    *cross-endpoint prefix fetch*: when the best-matching endpoint loses
    to the load guard, the chosen endpoint's allocator adopts the matched
    prefix through the cluster :class:`~repro_torch.kvcache.TransferEngine`
    (kind ``prefix_fetch``, wire time on the destination's link) so the
    hot prefix replicates to where traffic actually lands. The fetch is a
    cache warm — it gates no request — and models KV movement only, so it
    is limited to the simulated (``executor="null"``) path: real paged
    pools would need cross-pool page copies.
    """

    def __init__(self, fallback: Optional[Router] = None,
                 min_match: int = 16, max_imbalance: int = 4,
                 index_size: int = 65536, fetch: bool = False,
                 min_fetch: int = 512):
        self.fallback = fallback or LeastLoadedRouter()
        self.min_match = min_match
        self.max_imbalance = max_imbalance
        self.index_size = index_size
        self.fetch = fetch
        self.min_fetch = min_fetch
        self._index: OrderedDict = OrderedDict()   # hash -> {endpoint names}
        self._runtime = None
        self.n_fetches = 0

    def bind_runtime(self, runtime) -> None:
        """Called by :class:`~repro_torch.cluster.runtime.ClusterRuntime` on
        construction: gives the router access to the cluster transfer
        engine for prefix fetches."""
        self._runtime = runtime

    # ------------------------------------------------------------------
    def _prompt_hashes(self, req, block_size: int) -> List[bytes]:
        hashes, h = [], b""
        prompt = req.prompt
        for lo in range(0, len(prompt) - block_size + 1, block_size):
            h = _chain(h, prompt[lo:lo + block_size])
            hashes.append(h)
        return hashes

    def _index_match(self, name: str, hashes: List[bytes],
                     block_size: int) -> int:
        n = 0
        for h in hashes:
            holders = self._index.get(h)
            if not holders or name not in holders:
                break
            n += block_size
        return n

    def _record(self, name: str, hashes: List[bytes]):
        for h in hashes:
            holders = self._index.get(h)
            if holders is None:
                self._index[h] = {name}
            else:
                holders.add(name)
                self._index.move_to_end(h)
        while len(self._index) > self.index_size:
            self._index.popitem(last=False)

    def _maybe_fetch(self, req, src: Endpoint, dst: Endpoint,
                     n_tokens: int, hashes: List[bytes]) -> None:
        if (not self.fetch or self._runtime is None
                or n_tokens < self.min_fetch):
            return
        eng = dst.engines[-1]
        if eng.ecfg.executor != "null" or not eng.ecfg.prefix_cache:
            return
        alloc = eng.allocator
        self._runtime.transfers.transfer(
            req, src=src.name, dst=dst.name,
            deliver=lambda r, a=alloc, n=n_tokens: a.adopt_prefix(r.prompt, n),
            when=max(req.arrival, src.stats().clock),
            n_tokens=n_tokens, device_model=eng.device,
            charge="link", kind="prefix_fetch")
        self._record(dst.name, hashes)
        self.n_fetches += 1

    # ------------------------------------------------------------------
    def select(self, req, endpoints):
        """Best KV-holding endpoint (index + two-tier probe), under the
        load guard; optionally fetches the prefix to the loaded choice."""
        bs = endpoints[0].engines[-1].ecfg.block_size
        hashes = self._prompt_hashes(req, bs)
        cands = [ep for ep in endpoints if ep.can_accept(req)]
        if not cands:
            return None
        best, best_len = None, self.min_match - 1
        for ep in cands:
            n = max(ep.cached_prefix_tokens(req),
                    self._index_match(ep.name, hashes, bs))
            if n > best_len:
                best, best_len = ep, n
        if best is not None:
            floor = min(ep.stats().queue_depth for ep in cands)
            if best.stats().queue_depth <= floor + self.max_imbalance:
                self._record(best.name, hashes)
                return best
        ep = self.fallback.select(req, endpoints)
        if ep is not None:
            if best is not None and ep is not best:
                # the prefix lives on `best` but load pushed the request
                # to `ep`: optionally replicate the hot prefix over there
                self._maybe_fetch(req, best, ep, best_len, hashes)
            self._record(ep.name, hashes)
        return ep

    def on_membership_change(self, endpoints):
        """Scrub detached endpoints out of the content index."""
        # scrub detached endpoints out of the content index (their pools
        # left with them); entries with no holder left disappear
        live = {ep.name for ep in endpoints}
        for h in list(self._index):
            holders = self._index[h] & live
            if holders:
                self._index[h] = holders
            else:
                del self._index[h]
        self.fallback.on_membership_change(endpoints)


ROUTERS = {
    "round_robin": RoundRobinRouter,
    "least_loaded": LeastLoadedRouter,
    "session": SessionAffinityRouter,
    "prefix_affinity": PrefixAffinityRouter,
    "kv_aware": KVAwareRouter,
}


def make_router(name: str, **kw) -> Router:
    """Instantiate a registered router by name (see ``ROUTERS``)."""
    try:
        return ROUTERS[name](**kw)
    except KeyError:
        raise KeyError(f"unknown router {name!r}; "
                       f"choose from {sorted(ROUTERS)}") from None
