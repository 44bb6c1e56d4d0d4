"""Online serving API: declarative :class:`ServeSpec` + request-level
:class:`InferenceService`.

Cronus is an *online* system — requests arrive continuously and TTFT/TBT
tail latency is the product — but until this module the only public
surface was offline: thread kwargs through five builders
(``build_cronus`` / ``build_dp`` / ``build_pp`` / ``build_cluster`` /
``build_system``) and call ``run(full_trace)``. This module replaces that
with the two layers production stacks expose:

``ServeSpec``
    One frozen dataclass describing the whole deployment — model arch,
    pair vs cluster topology, router, scheduling policy, prefix caching,
    executor, KV sizing. JSON round-trippable (``to_dict``/``from_dict``),
    argparse round-trippable (``add_cli_args``/``from_cli``), validated at
    construction, and ``build()`` materialises it into a running service,
    subsuming the kwarg plumbing of the five builders.

``InferenceService``
    The online facade over :class:`~repro_torch.cluster.runtime.ClusterRuntime`:
    ``submit(req) -> RequestHandle`` (streaming via ``handle.tokens()``,
    driven by the per-token emission hook in ``Engine.step``),
    ``handle.cancel()`` (frees slots/KV blocks mid-flight, records the
    ``cancelled`` terminal metric), ``step_until(t)`` incremental
    simulation, and ``drain()``. The legacy batch surface survives as the
    thin wrapper ``run(requests)`` = submit-all + drain, bit-identical on
    metrics to the builders' ``system.run(trace)``.

Example::

    spec = ServeSpec(cluster="2xcronus:A100+A10,4xworker:A10",
                     router="least_loaded", sched_policy="sarathi")
    service = spec.build()
    handle = service.submit(Request("r0", prompt, output_len=64))
    for token, t in handle.tokens():      # advances simulated time
        ...
    metrics = service.drain()
"""
from __future__ import annotations

import dataclasses
import json
from collections import deque
from typing import Callable, Deque, Dict, Iterator, List, Optional, Tuple

import torch

from repro_torch.cluster.router import ROUTERS, Router, RoundRobinRouter, make_router
from repro_torch.cluster.runtime import (ClusterRuntime, Endpoint, WorkerEndpoint,
                                   check_requests_fresh)
from repro_torch.cluster.topology import build_cluster, parse_cluster_spec
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.core.executor import PagedRealExecutor, RealExecutor
from repro_torch.core.metrics import RequestMetrics, aggregate
from repro_torch.core.request import ReqState, Request
from repro_torch.models.transformer import DecoderModel, check_device
from repro_torch.scheduling import SCHEDULERS
from repro_torch.serving.hardware import DEVICES
from repro_torch.serving.simulator import APPROACHES, build_system
from repro_torch.workloads.arrivals import parse_arrival

EXECUTORS = ("null", "real", "paged")


@dataclasses.dataclass(frozen=True)
class ServeSpec:
    """Declarative description of one serving deployment — the single
    source of truth ``launch/serve.py`` and the examples build from.

    Topology is either a single heterogeneous pair (``approach`` over the
    ``hi``/``lo`` devices — one of ``cronus | dp | pp | disagg_hl |
    disagg_lh``) or a whole cluster (``cluster`` DSL string such as
    ``"2xcronus:A100+A10,4xworker:A10@sjf"``, which overrides
    ``approach``/``hi``/``lo``).

    ``router=None`` picks the approach-appropriate default: the weighted
    round-robin of the paper's DP baseline, plain round-robin for
    single-endpoint topologies, least-loaded for clusters — exactly what
    the legacy ``system.run`` paths used, so a default spec reproduces
    their metrics bit-for-bit.

    ``executor="real"`` runs real PyTorch compute on a per-slot cache and
    needs ``s_kv`` — the per-slot KV capacity in tokens, normally the max
    ``input_len + output_len`` of the workload plus headroom.
    ``executor="paged"`` also runs real compute but stores KV in a block
    pool indexed by the engine's block tables (paged attention), so
    prefix caching / ``@cache`` work on real compute; its pool size is
    ``num_kv_blocks`` (default ``max_slots * ceil(s_kv / block_size)``).
    """

    arch: str = "llama3-8b"
    smoke: bool = False                   # reduced model config
    approach: str = "cronus"              # one of APPROACHES (pair mode)
    hi: str = "A100"                      # high-end device (pair mode)
    lo: str = "A10"                       # low-end device (pair mode)
    cluster: Optional[str] = None         # topology DSL; overrides approach
    router: Optional[str] = None          # None = approach-appropriate
    sched_policy: str = "fcfs"            # iteration-level batch policy
    prefix_cache: bool = False            # shared-prefix KV reuse (null/paged)
    executor: str = "null"                # "null" (sim) | "real" | "paged"
    max_slots: int = 256                  # resident-request limit per engine
    block_size: int = 16                  # KV block granularity
    max_batched_tokens: int = 512         # chunked-prefill token budget
    s_kv: Optional[int] = None            # real executor: KV tokens per slot
    chunk_pad: Optional[int] = None       # real executor: pad chunks (jit)
    num_kv_blocks: Optional[int] = None   # paged executor: KV pool blocks
    host_kv_blocks: int = 0               # host-memory cache tier (0 = off)
    # open-loop arrival process for workload driving (repro_torch.workloads):
    # "fixed:I" | "poisson:RATE" | "burst:RATE[:B[:ON]]" | "ramp:LO:HI[:P]".
    # None = closed-loop trace replay (the historical behaviour).
    arrival: Optional[str] = None
    # elastic autoscaling (repro_torch.autoscale): policy spec string such as
    # "slo:goodput>=0.9:cooldown=5", plus the idle-device inventory the
    # autoscaler may attach ("A100:1,A10:4"). None = fixed fleet.
    autoscale: Optional[str] = None
    inventory: Optional[str] = None

    def __post_init__(self):
        self.validate()

    # ------------------------------------------------------------------
    # validation
    # ------------------------------------------------------------------
    def validate(self) -> None:
        """Refuse malformed or contradictory specs with one-line errors
        (the full matrix is documented in docs/OPERATIONS.md)."""
        if self.arch not in ARCH_IDS:
            raise ValueError(f"unknown arch {self.arch!r}; "
                             f"choose from {ARCH_IDS}")
        if self.cluster is not None:
            parse_cluster_spec(self.cluster)     # raises ValueError on DSL errors
        else:
            if self.approach not in APPROACHES:
                raise ValueError(f"unknown approach {self.approach!r}; "
                                 f"choose from {APPROACHES}")
            for dev in (self.hi, self.lo):
                if dev not in DEVICES:
                    raise ValueError(f"unknown device {dev!r}; "
                                     f"choose from {sorted(DEVICES)}")
        if self.router is not None and self.router not in ROUTERS:
            raise ValueError(f"unknown router {self.router!r}; "
                             f"choose from {sorted(ROUTERS)}")
        if self.sched_policy not in SCHEDULERS:
            raise ValueError(f"unknown sched policy {self.sched_policy!r}; "
                             f"choose from {sorted(SCHEDULERS)}")
        if self.executor not in EXECUTORS:
            raise ValueError(f"unknown executor {self.executor!r}; "
                             f"choose from {EXECUTORS}")
        if self.executor == "real" and (
                self.prefix_cache or "@cache" in (self.cluster or "")):
            raise ValueError(
                "prefix caching (prefix_cache / '@cache' node suffix) "
                "models KV reuse at the block-table level; the "
                "RealExecutor's slot cache cannot serve cached prefixes "
                "— use executor='paged', whose block-pool KV serves "
                "cache hits on real compute")
        for name in ("max_slots", "block_size", "max_batched_tokens"):
            if getattr(self, name) < 1:
                raise ValueError(f"{name} must be >= 1")
        if (self.cluster is None and self.approach in ("dp", "pp")
                and self.max_batched_tokens
                != self._default("max_batched_tokens")):
            # refuse rather than silently ignore: these baselines pin the
            # paper's §5.1 per-engine budgets (dp: 512 high / 256 low,
            # pp: 512) inside build_dp/build_pp
            raise ValueError(
                f"approach {self.approach!r} uses the paper's fixed "
                "per-engine token budgets (dp: 512/256, pp: 512); "
                "max_batched_tokens applies to cronus/disagg pairs and "
                "--cluster topologies")
        if self.s_kv is not None and self.s_kv < 1:
            raise ValueError("s_kv must be >= 1")
        if self.num_kv_blocks is not None:
            if self.num_kv_blocks < 1:
                raise ValueError("num_kv_blocks must be >= 1")
            if self.executor != "paged":
                raise ValueError(
                    "num_kv_blocks sizes the paged executor's real KV "
                    "pool; with executor="
                    f"{self.executor!r} the pool is device-HBM-derived "
                    "(set executor='paged')")
        if self.host_kv_blocks < 0:
            raise ValueError("host_kv_blocks must be >= 0")
        if self.host_kv_blocks > 0 and not (
                self.prefix_cache or "@cache" in (self.cluster or "")):
            raise ValueError(
                "host_kv_blocks adds a host-memory tier *behind the "
                "prefix cache* (demoted refcount-0 prefix blocks); it "
                "does nothing without prefix caching — set prefix_cache "
                "or an '@cache' node suffix")
        if self.arrival is not None:
            parse_arrival(self.arrival)   # raises ValueError on bad specs
        if self.autoscale is not None:
            from repro_torch.autoscale import DeviceInventory, parse_autoscale
            parse_autoscale(self.autoscale)  # raises ValueError on bad specs
            if self.executor in ("real", "paged"):
                raise ValueError(
                    "autoscale builds new endpoints on the fly; the "
                    "real executors' compiled model state cannot be "
                    "provisioned mid-run, so autoscaling is "
                    "simulation-only")
            if (self.inventory is None
                    or DeviceInventory.parse(self.inventory).total == 0):
                raise ValueError(
                    "autoscale needs a non-empty device inventory to "
                    "scale into — with a fixed endpoint set and an empty "
                    "rack there is nothing to attach "
                    "(set inventory='A100:1,A10:4'-style)")
        elif self.inventory is not None:
            raise ValueError(
                "inventory without autoscale does nothing — idle devices "
                "are only consumed by the autoscaler (set autoscale, "
                "e.g. 'slo:goodput>=0.9')")

    # ------------------------------------------------------------------
    # serialization (JSON round-trip)
    # ------------------------------------------------------------------
    def to_dict(self) -> Dict:
        """The spec as a plain JSON-ready dict."""
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict) -> "ServeSpec":
        """Inverse of :meth:`to_dict`; unknown keys are refused."""
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - known
        if unknown:
            raise ValueError(f"unknown ServeSpec keys {sorted(unknown)}; "
                             f"known: {sorted(known)}")
        return cls(**d)

    @classmethod
    def from_json_file(cls, path: str) -> "ServeSpec":
        """Load a spec from a JSON file (``serve.py --spec``)."""
        with open(path) as f:
            return cls.from_dict(json.load(f))

    def replace(self, **changes) -> "ServeSpec":
        """A copy with ``changes`` applied (re-validated)."""
        return dataclasses.replace(self, **changes)

    @classmethod
    def from_plan(cls, plan, rank: int = 0, rate: Optional[float] = None,
                  **overrides) -> "ServeSpec":
        """A spec that serves a planner recommendation. The planner
        (``autotopo``) is not ported yet, so this raises
        ``NotImplementedError``."""
        raise NotImplementedError(
            "ServeSpec.from_plan needs the auto-topology planner "
            "(autotopo), which is not ported yet")

    # ------------------------------------------------------------------
    # argparse round-trip (serve.py's system flags live HERE so the CLI
    # can never drift from the spec — see tests/test_api.py)
    # ------------------------------------------------------------------
    @classmethod
    def add_cli_args(cls, ap) -> None:
        """Generate one CLI flag per spec field (serve.py's system
        flags; a test asserts the CLI covers every field)."""
        g = ap.add_argument_group(
            "serving spec", "system topology and policies (ServeSpec)")
        g.add_argument("--arch", default=cls._default("arch"),
                       choices=ARCH_IDS)
        g.add_argument("--smoke", action="store_true",
                       help="use the reduced model config")
        g.add_argument("--approach", default=cls._default("approach"),
                       choices=APPROACHES)
        g.add_argument("--hi", default=cls._default("hi"),
                       choices=sorted(DEVICES))
        g.add_argument("--lo", default=cls._default("lo"),
                       choices=sorted(DEVICES))
        g.add_argument("--cluster", default=None,
                       help="cluster spec, e.g. "
                            "'2xcronus:A100+A10,4xworker:A10' "
                            "(overrides --approach/--hi/--lo)")
        g.add_argument("--router", default=None, choices=sorted(ROUTERS),
                       help="cluster request router (default: approach-"
                            "appropriate — weighted RR for dp, "
                            "least-loaded for --cluster)")
        g.add_argument("--sched-policy", default=cls._default("sched_policy"),
                       choices=sorted(SCHEDULERS),
                       help="iteration-level batch-composition policy "
                            "(fcfs = seed-identical); per-endpoint "
                            "override via '@policy' in --cluster")
        g.add_argument("--prefix-cache", action="store_true",
                       help="shared-prefix KV reuse (null or paged "
                            "executor; per-endpoint override via "
                            "'@cache')")
        g.add_argument("--real", action="store_true",
                       help="real PyTorch execution (executor='real'; "
                            "use with --smoke and a scaled trace on "
                            "the CPU)")
        g.add_argument("--executor", default=None, choices=EXECUTORS,
                       help="compute backend: null (simulated), real "
                            "(per-slot dense KV), paged (block-pool KV "
                            "driven by the engine's block tables; "
                            "prefix-cache capable). Overrides --real")
        g.add_argument("--max-slots", type=int, default=None,
                       help="resident-request limit per engine "
                            "(default 256; 16 with --real)")
        g.add_argument("--block-size", type=int, default=None,
                       help="KV block granularity (default 16; 4 with "
                            "--real)")
        g.add_argument("--max-batched-tokens", type=int,
                       default=cls._default("max_batched_tokens"),
                       help="chunked-prefill token budget per iteration")
        g.add_argument("--s-kv", type=int, default=None,
                       help="real executor: KV capacity per slot in "
                            "tokens (default: derived from the trace)")
        g.add_argument("--chunk-pad", type=int, default=None,
                       help="real executor: pad prefill chunks to this "
                            "multiple (fewer jit recompiles)")
        g.add_argument("--num-kv-blocks", type=int, default=None,
                       help="paged executor: KV pool size in blocks per "
                            "engine (default: max_slots * "
                            "ceil(s_kv / block_size))")
        g.add_argument("--host-kv-blocks", type=int,
                       default=cls._default("host_kv_blocks"),
                       help="host-memory KV cache tier in blocks per "
                            "engine: refcount-0 prefix blocks demote to "
                            "host DRAM and promote back on a hit, PCIe "
                            "cost charged (needs --prefix-cache or "
                            "'@cache'; per-node override via '@host')")
        g.add_argument("--arrival", default=cls._default("arrival"),
                       metavar="PROC",
                       help="open-loop arrival process: fixed:I | "
                            "poisson:RATE | burst:RATE[:BURSTINESS"
                            "[:MEAN_ON]] | ramp:LO:HI[:PERIOD] "
                            "(default: closed-loop replay at --interval)")
        g.add_argument("--autoscale", default=cls._default("autoscale"),
                       metavar="POLICY",
                       help="elastic autoscaling policy, e.g. "
                            "'slo:goodput>=0.9:cooldown=5' "
                            "(default: fixed fleet; needs --inventory)")
        g.add_argument("--inventory", default=cls._default("inventory"),
                       metavar="DEVICES",
                       help="idle devices the autoscaler may attach, "
                            "e.g. 'A100:1,A10:4'")

    @classmethod
    def from_cli(cls, args) -> "ServeSpec":
        """Build a spec from parsed CLI args (inverse of
        :meth:`add_cli_args`, with the --real back-compat sizing)."""
        executor = getattr(args, "executor", None) or (
            "real" if getattr(args, "real", False) else "null")
        # real-compute runs keep the historical CPU-scale defaults unless
        # overridden (--real is the back-compat spelling of executor=real)
        max_slots = args.max_slots if args.max_slots is not None else (
            16 if executor != "null" else cls._default("max_slots"))
        block_size = args.block_size if args.block_size is not None else (
            4 if executor != "null" else cls._default("block_size"))
        return cls(arch=args.arch, smoke=args.smoke, approach=args.approach,
                   hi=args.hi, lo=args.lo, cluster=args.cluster,
                   router=args.router, sched_policy=args.sched_policy,
                   prefix_cache=args.prefix_cache, executor=executor,
                   max_slots=max_slots, block_size=block_size,
                   max_batched_tokens=args.max_batched_tokens,
                   s_kv=args.s_kv, chunk_pad=args.chunk_pad,
                   num_kv_blocks=getattr(args, "num_kv_blocks", None),
                   host_kv_blocks=getattr(args, "host_kv_blocks", 0),
                   arrival=args.arrival, autoscale=args.autoscale,
                   inventory=args.inventory)

    @classmethod
    def _default(cls, field: str):
        return cls.__dataclass_fields__[field].default

    # ------------------------------------------------------------------
    # materialisation
    # ------------------------------------------------------------------
    def build(self, model=None, params=None, *,
              device="cuda") -> "InferenceService":
        """Build engines, endpoints and router per this spec and wrap
        them in an online :class:`InferenceService`.

        ``executor="real"`` and ``"paged"`` accept a pre-built
        :class:`~repro_torch.models.transformer.DecoderModel` and/or its
        ``params`` (otherwise the weights are drawn once on ``device``
        from a ``torch.Generator`` seeded 0); ``"real"`` requires
        ``s_kv``. ``device`` defaults to the card: with no CUDA device a
        real-compute build raises ``RuntimeError``; pass ``device="cpu"``
        to run on the CPU. ``executor="null"`` needs no device.
        """
        cfg = get_config(self.arch, smoke=self.smoke)
        factory = self._executor_factory(cfg, model, params, device)
        num_kv_blocks = self.effective_num_kv_blocks()
        if self.cluster is not None:
            system = build_cluster(
                cfg, self.cluster, router=self.router or "least_loaded",
                executor_factory=factory, max_slots=self.max_slots,
                block_size=self.block_size,
                max_batched_tokens=self.max_batched_tokens,
                sched_policy=self.sched_policy,
                prefix_cache=self.prefix_cache,
                num_kv_blocks=num_kv_blocks,
                host_kv_blocks=self.host_kv_blocks, executor=self.executor)
            service = InferenceService(system.endpoints, system.router,
                                       spec=self, cfg=cfg, system=system)
        else:
            system = build_system(
                self.approach, cfg, DEVICES[self.hi], DEVICES[self.lo],
                executor_factory=factory, max_slots=self.max_slots,
                block_size=self.block_size,
                max_batched_tokens=self.max_batched_tokens,
                sched_policy=self.sched_policy,
                prefix_cache=self.prefix_cache,
                num_kv_blocks=num_kv_blocks,
                host_kv_blocks=self.host_kv_blocks, executor=self.executor)
            endpoints, router = self._pair_endpoints(system)
            service = InferenceService(endpoints, router, spec=self,
                                       cfg=cfg, system=system)
        # how the autoscaler builds scale-up endpoints that match the
        # fleet's engine-level policies
        service.build_kw = dict(
            executor_factory=factory, max_slots=self.max_slots,
            block_size=self.block_size,
            max_batched_tokens=self.max_batched_tokens,
            sched_policy=self.sched_policy, prefix_cache=self.prefix_cache,
            num_kv_blocks=num_kv_blocks,
            host_kv_blocks=self.host_kv_blocks, executor=self.executor)
        if self.autoscale is not None:
            from repro_torch.autoscale import (Autoscaler, DeviceInventory,
                                         parse_autoscale)
            service.attach_autoscaler(Autoscaler(
                DeviceInventory.parse(self.inventory),
                policy=parse_autoscale(self.autoscale)))
        return service

    def _pair_endpoints(self, system) -> Tuple[List[Endpoint], Router]:
        """Endpoint + router wiring for the five single-pair approaches —
        identical to what each system's legacy ``run()`` assembles, so
        default-spec services reproduce their metrics bit-for-bit."""
        if self.approach == "dp":
            endpoints: List[Endpoint] = system.endpoints()
            default: Router = RoundRobinRouter(weights=system.weights)
        elif self.approach == "pp":
            endpoints = [WorkerEndpoint(system.engine.name, system.engine,
                                        queue_cap=None)]
            default = RoundRobinRouter()
        else:                       # cronus / disagg_hl / disagg_lh
            endpoints = [system.endpoint()]
            default = RoundRobinRouter()
        router = make_router(self.router) if self.router else default
        return endpoints, router

    def effective_num_kv_blocks(self) -> Optional[int]:
        """KV pool size handed to the builders: the explicit override, or
        for ``executor="paged"`` a pool that matches the slot executor's
        aggregate capacity (``max_slots * ceil(s_kv / block_size)``) so
        slot and paged runs admit identical batches by default. ``None``
        (simulated / slot paths with no override) keeps each engine's
        device-HBM-derived budget."""
        if self.num_kv_blocks is not None:
            return self.num_kv_blocks
        if self.executor == "paged":
            if self.s_kv is None:
                raise ValueError(
                    "executor='paged' needs s_kv (to size the default "
                    "num_kv_blocks pool) or an explicit num_kv_blocks")
            return self.max_slots * -(-self.s_kv // self.block_size)
        return None

    def _executor_factory(self, cfg, model, params, device) -> Callable:
        if self.executor == "null":
            from repro_torch.core.executor import NullExecutor
            return lambda role: NullExecutor()
        if self.executor == "real" and self.s_kv is None:
            raise ValueError(
                "executor='real' needs s_kv (per-slot KV capacity in "
                "tokens) — spec.replace(s_kv=max context + headroom)")
        if self.executor == "paged":
            self.effective_num_kv_blocks()   # validate sizing up front
            return paged_executor_factory(cfg, model, params, device=device)
        return slot_executor_factory(cfg, model, params, device=device,
                                     max_slots=self.max_slots,
                                     s_kv=self.s_kv,
                                     chunk_pad=self.chunk_pad)


# ---------------------------------------------------------------------------
# the online facade
# ---------------------------------------------------------------------------

class RequestHandle:
    """Live view of one submitted request: stream its tokens, wait for
    its result, or cancel it mid-flight. Obtained from
    :meth:`InferenceService.submit` — never constructed directly."""

    def __init__(self, request: Request, service: "InferenceService"):
        self.request = request
        self._service = service
        self._streaming = False        # buffer only once tokens() is asked
        self._stream: Deque[Tuple[int, float]] = deque()

    @property
    def req_id(self) -> str:
        """The underlying request's id."""
        return self.request.req_id

    @property
    def done(self) -> bool:
        """Whether the request finished (not cancelled)."""
        return self.request.state is ReqState.FINISHED

    @property
    def cancelled(self) -> bool:
        """Whether the request was cancelled."""
        return self.request.metrics.cancelled

    @property
    def status(self) -> str:
        """``queued | running | finished | cancelled`` (coarse view of
        the engine-level request state)."""
        if self.cancelled:
            return "cancelled"
        if self.done:
            return "finished"
        if self.request.state is ReqState.WAITING and self.request.slot is None:
            return "queued"
        return "running"

    def _subscribe(self) -> None:
        """Start buffering live emissions, seeding the stream with every
        token already delivered. Emitted history = tokens folded into the
        prompt by preemption-recompute (they sit past the original
        ``metrics.input_len``) + the current ``generated`` list, with one
        timestamp each in ``first_token_time`` + ``token_times`` — exact
        under every policy, so late subscribers miss nothing. Nothing is
        buffered for handles nobody streams (batch ``run`` stays O(1) in
        token memory)."""
        self._streaming = True
        m = self.request.metrics
        if m.first_token_time is None:
            return
        hist = (list(self.request.prompt[m.input_len:])
                + list(self.request.generated))
        times = [m.first_token_time] + list(m.token_times)
        self._stream.extend(zip(hist, times))

    def tokens(self) -> Iterator[Tuple[int, float]]:
        """Stream ``(token_id, sim_time)`` pairs as the request generates
        them, advancing the whole cluster's simulated time as needed.
        Ends after the final token, or immediately on cancellation."""
        if not self._streaming:
            self._subscribe()
        while True:
            while self._stream:
                yield self._stream.popleft()
            if self.done or self.cancelled:
                return
            if not self._service.step():
                return      # cluster stalled with nothing left to do

    def result(self) -> RequestMetrics:
        """Block (in simulated time) until this request finishes or is
        cancelled; returns its metrics."""
        while not (self.done or self.cancelled):
            if not self._service.step():
                break
        return self.request.metrics

    def cancel(self) -> bool:
        """Abort mid-flight: frees the request's slot and KV blocks
        wherever it lives (pending, queued, prefilling on a PPI, in KV
        transit, or decoding) and records the ``cancelled`` terminal
        state. False if already finished/cancelled."""
        return self._service.cancel(self)


class InferenceService:
    """Request-level online facade over a built cluster.

    Drives :class:`~repro_torch.cluster.runtime.ClusterRuntime` incrementally:
    ``submit`` enqueues work at its ``arrival`` time, ``step`` executes
    one event-loop round, ``step_until(t)`` advances simulated time,
    ``drain`` runs everything to completion. ``run(requests)`` is the
    legacy batch surface as a thin wrapper (submit-all + drain) and is
    bit-identical on metrics to the builders' ``system.run(trace)``.
    """

    def __init__(self, endpoints: List[Endpoint], router: Router, *,
                 spec: Optional[ServeSpec] = None, cfg=None, system=None):
        self.runtime = ClusterRuntime(endpoints, router)
        self.spec = spec
        self.cfg = cfg
        self.system = system          # the underlying builder product
        self._pending: Deque[Request] = deque()
        self._handles: Dict[str, RequestHandle] = {}
        self._n_cancelled = 0
        self._autoscaler = None
        self.build_kw: Dict = {}      # scale-up endpoint construction kwargs
        for eng in self.runtime.engines:
            eng.on_token = self._on_token

    # ------------------------------------------------------------------
    # flight recorder (repro_torch.obs)
    # ------------------------------------------------------------------
    @property
    def tracer(self):
        """The active tracer, or None (tracing off = zero overhead)."""
        return self.runtime.tracer

    def start_trace(self):
        """Switch the flight recorder on: create a
        :class:`~repro_torch.obs.Tracer`, register one Perfetto track per
        engine (grouped per endpoint), and thread it through the
        runtime, every engine, and each engine's allocator. Idempotent —
        a second call returns the live tracer. Call before submitting
        work for a complete record."""
        if self.runtime.tracer is None:
            from repro_torch.obs import Tracer
            self.runtime.tracer = Tracer()
            for ep in self.runtime.endpoints:
                self._wire_trace(ep)
        return self.runtime.tracer

    def _wire_trace(self, ep: Endpoint) -> None:
        """Register ``ep``'s engines as trace tracks. Lane naming matches
        the transfer engine's pool names (``endpoint/engine`` for pairs,
        bare ``endpoint`` for single-engine workers), so flow arrows land
        on the lanes the iteration spans live on."""
        tracer = self.runtime.tracer
        multi = len(ep.engines) > 1
        for eng in ep.engines:
            track = tracer.track(ep.name, eng.name if multi else "main")
            eng.tracer = tracer
            eng.trace_track = track
            eng.allocator.trace_engine = eng
            device = getattr(getattr(eng.device, "spec", None), "name",
                             type(eng.device).__name__)
            tracer.instant(track, "track_meta", eng.clock,
                           {"device": device,
                            "prefill_only": eng.ecfg.prefill_only,
                            "decode_only": eng.ecfg.decode_only,
                            "sched_policy": eng.ecfg.sched_policy},
                           cat="metadata")

    def export_trace(self, path: str) -> None:
        """Write the recorded trace as Perfetto-loadable Chrome JSON."""
        if self.runtime.tracer is None:
            raise ValueError("tracing was never started — call "
                             "start_trace() before the run")
        self.runtime.tracer.export(path)

    def _on_token(self, req: Request, token: int, t: float) -> None:
        # Engine.step emission hook: buffer into the request's handle for
        # its tokens() stream — but only for subscribed handles, so plain
        # batch replays retain no token history. PPI prefill views never
        # emit (prefill-only path), so each delivered token arrives here
        # exactly once.
        h = self._handles.get(req.req_id)
        if h is not None and h._streaming:
            h._stream.append((token, t))

    # ------------------------------------------------------------------
    @property
    def endpoints(self) -> List[Endpoint]:
        """Current cluster membership."""
        return self.runtime.endpoints

    @property
    def engines(self):
        """Every engine across the current membership."""
        return self.runtime.engines

    @property
    def now(self) -> float:
        """Simulated time the cluster has reached (max engine clock)."""
        return max((e.clock for e in self.runtime.engines), default=0.0)

    @property
    def n_submitted(self) -> int:
        """Requests submitted over this service's lifetime."""
        return len(self._handles)

    @property
    def n_cancelled(self) -> int:
        """Requests cancelled before completion."""
        return self._n_cancelled

    @property
    def n_finished(self) -> int:
        """Requests completed (including detached endpoints' retirees)."""
        return self.runtime.n_finished()

    @property
    def n_active(self) -> int:
        """Submitted requests still owed a completion."""
        return self.n_submitted - self._n_cancelled - self.n_finished

    @property
    def autoscaler(self):
        """The attached autoscaler, or None."""
        return self._autoscaler

    def oldest_pending_arrival(self) -> Optional[float]:
        """Arrival time of the oldest not-yet-routed submission (the
        autoscaler's view of queueing that never reached an endpoint)."""
        return self._pending[0].arrival if self._pending else None

    # ------------------------------------------------------------------
    # elastic membership (autoscaling surface)
    # ------------------------------------------------------------------
    def attach_endpoint(self, ep: Endpoint, now: Optional[float] = None
                        ) -> None:
        """Add a live endpoint mid-run (see
        :meth:`ClusterRuntime.attach_endpoint`) and wire its engines into
        this service's token-emission stream."""
        self.runtime.attach_endpoint(ep, now=now)
        for eng in ep.engines:
            eng.on_token = self._on_token
        if self.runtime.tracer is not None:
            self._wire_trace(ep)

    def detach_endpoint(self, name: str, migrate: bool = True) -> Endpoint:
        """Remove a live endpoint: its residents re-enter this service's
        pending queue (no request is lost; each re-routes on a later
        tick) and its finished requests fold into the fleet's metrics via
        ``runtime.retired``. By default residents *migrate* — their
        computed KV travels with them through the cluster
        :class:`~repro_torch.kvcache.TransferEngine` to any endpoint that will
        ingest it, falling back to recompute only when none does — so
        scale-down never pays for re-prefilling work it already paid for.
        ``migrate=False`` forces the drain-by-recompute path."""
        return self.runtime.detach_endpoint(name, pending=self._pending,
                                            migrate=migrate)

    def attach_autoscaler(self, autoscaler) -> None:
        """Hand the scaling loop this service: ``autoscaler.on_tick`` runs
        after every ``step``. With no autoscaler attached the service
        behaves bit-identically to a fixed fleet."""
        self._autoscaler = autoscaler
        autoscaler.bind(self)

    # ------------------------------------------------------------------
    # the online surface
    # ------------------------------------------------------------------
    def submit(self, request: Request) -> RequestHandle:
        """Take ownership of a fresh request; it will be routed once
        simulated time reaches ``request.arrival``."""
        if request.req_id in self._handles:
            raise ValueError(f"duplicate req_id {request.req_id!r}")
        check_requests_fresh([request])
        # keep pending sorted by arrival, stable for ties — the dispatch
        # discipline ClusterRuntime.run's up-front sort establishes
        i = len(self._pending)
        while i > 0 and self._pending[i - 1].arrival > request.arrival:
            i -= 1
        self._pending.insert(i, request)
        handle = RequestHandle(request, self)
        self._handles[request.req_id] = handle
        tracer = self.runtime.tracer
        if tracer is not None:
            tracer.instant(tracer.control, "submit", request.arrival,
                           {"req": request.req_id,
                            "input_len": request.input_len,
                            "output_len": request.output_len})
            tracer.async_begin(tracer.control, "request", request.arrival,
                               request.req_id)
        return handle

    def cancel(self, handle: RequestHandle) -> bool:
        """Cancel a submitted request wherever it lives (pending queue
        or any endpoint); frees its slot and KV. False if already done."""
        req = handle.request
        if handle.done or handle.cancelled:
            return False
        if any(r is req for r in self._pending):      # never routed
            self._pending = deque(r for r in self._pending if r is not req)
            req.state = ReqState.CANCELLED
            req.metrics.cancelled = True
            req.metrics.cancel_time = self.now
            tracer = self.runtime.tracer
            if tracer is not None:
                tracer.instant(tracer.control, "cancel", self.now,
                               {"req": req.req_id, "pending": True})
                tracer.async_end(tracer.control, "request", self.now,
                                 req.req_id, {"cancelled": True})
        else:
            for ep in self.runtime.endpoints:
                if ep.cancel(req):
                    break
            else:
                return False
        self._n_cancelled += 1
        return True

    def step(self) -> bool:
        """One event-loop round; False when no progress is possible."""
        progressed = self.runtime.tick(self._pending)
        if self._autoscaler is not None:
            # a scaling action counts as progress: a stalled cluster that
            # just attached capacity has new work to do next round
            acted = self._autoscaler.on_tick(self)
            return progressed or acted is not None
        return progressed

    def step_until(self, t: float, max_steps: int = 10_000_000, *,
                   strict: bool = False) -> float:
        """Advance the cluster through every action due at or before
        simulated time ``t``; returns the time actually reached.
        ``strict=True`` stops short of actions due exactly at ``t`` — the
        open-loop driver uses it so a submission at ``t`` lands *before*
        the tick that executes time ``t``, matching the closed loop's
        dispatch-before-advance order within a tick. (Strict mode gates on
        ``next_action_time`` — the clock of the iteration ``tick`` will
        actually run — because ``next_time``'s delivery-only candidates
        can sit earlier than every runnable engine.)"""
        steps = 0
        while steps < max_steps:
            if strict:
                nt = self.runtime.next_action_time(self._pending)
                if nt is None or nt >= t:
                    break
            else:
                nt = self.runtime.next_time(self._pending)
                if nt is None or nt > t:
                    break
            steps += 1
            if not self.step():
                break
        return self.now

    def drain(self, max_steps: int = 10_000_000) -> Dict[str, float]:
        """Run until every non-cancelled submission finished; returns
        aggregate metrics (see :meth:`metrics`)."""
        steps = 0
        while self.n_active > 0 and steps < max_steps:
            steps += 1
            if not self.step():
                break
        return self.metrics()

    def metrics(self, ttft_slo: Optional[float] = None,
                tbt_slo: Optional[float] = None,
                queueing: bool = False,
                utilization: bool = False) -> Dict[str, float]:
        """Fleet QoE aggregate over everything terminal so far. Finished
        requests feed throughput/latency; cancelled ones only the
        ``cancelled`` count (they never enter throughput aggregates).
        ``queueing=True`` (the open-loop driver's view) adds the
        queueing/service split of TTFT. ``utilization=True`` adds a
        per-endpoint breakdown (trailing-window ``busy_frac``, max queued
        age, router ``dispatched`` count, ``completed`` count) under one
        ``"utilization"`` key — how planner probes attribute a miss to
        the endpoint that caused it. Both opt-in: the default dict stays
        byte-identical."""
        ms = [r.metrics for ep in self.runtime.endpoints
              for r in ep.finished()]
        ms += [r.metrics for r in self.runtime.retired]
        ms += [h.request.metrics for h in self._handles.values()
               if h.request.metrics.cancelled]
        util = None
        if utilization:
            util = {}
            for ep in self.runtime.endpoints:
                s = ep.stats()
                util[ep.name] = {
                    "busy_frac": s.busy_frac,
                    "oldest_queued_age": s.oldest_queued_age,
                    "dispatched": self.runtime.dispatched.get(ep.name, 0),
                    "completed": ep.n_finished(),
                }
            # cluster-wide KV movement (per-kind token counters +
            # cancellation stats) — only when transfers actually ran, so
            # transfer-free topologies keep their exact utilization dict
            if self.runtime.transfers.n_transfers > 0:
                util["transfers"] = self.runtime.transfers.stats()
        return aggregate(ms, ttft_slo, tbt_slo, queueing=queueing,
                         utilization=util)

    # ------------------------------------------------------------------
    # the legacy batch surface
    # ------------------------------------------------------------------
    def run(self, requests: List[Request],
            max_steps: int = 10_000_000) -> Dict[str, float]:
        """Replay a whole trace: submit-all + drain. Metrics are
        bit-identical to the legacy ``system.run(trace)`` of the
        underlying builders."""
        for r in requests:
            self.submit(r)
        return self.drain(max_steps)


def serve(spec: ServeSpec, **replacements) -> InferenceService:
    """Convenience one-liner: ``serve(spec, sched_policy="sarathi")``."""
    if replacements:
        spec = spec.replace(**replacements)
    return spec.build()


# ---------------------------------------------------------------------------
# real-compute executor factories (the ported part of this module)
# ---------------------------------------------------------------------------

def _model_on(cfg, model: Optional[DecoderModel], params: Optional[Dict],
              device) -> Tuple[DecoderModel, Dict]:
    """The model and params real executors share, checked to lie on
    ``device``. Without ``model`` and ``params`` the weights are drawn on
    ``device`` from a ``torch.Generator`` seeded 0."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("real executors: no CUDA device (pass "
                           "device='cpu' to run on the CPU)")
    if model is None:
        if params is None:
            gen = torch.Generator(device=device).manual_seed(0)
            model = DecoderModel(cfg, device=device, generator=gen)
        else:
            model = DecoderModel(cfg, params, device=device)
    check_device(model.params, device, "model.params")
    if params is None:
        params = model.params
    check_device(params, device)
    return model, params


def paged_executor_factory(cfg, model: Optional[DecoderModel] = None,
                           params: Optional[Dict] = None, *,
                           device="cuda",
                           use_kernels: Optional[bool] = None) -> Callable:
    """``factory(role) -> PagedRealExecutor``: one executor (and block
    pool) per engine, all sharing one copy of the weights.

    Without ``model`` and ``params``, the weights are drawn on ``device``
    from a ``torch.Generator`` seeded 0. ``device`` defaults to
    the card: with no CUDA device this raises ``RuntimeError`` rather than
    carry on on the CPU; pass ``device="cpu"`` for the plain versions. A
    ``model`` or ``params`` that lies elsewhere than ``device`` raises
    ``ValueError``. ``use_kernels`` is handed to every executor (``None``:
    the CUDA kernels on the card, the plain versions on the CPU).
    """
    model, params = _model_on(cfg, model, params, device)

    def factory(role: str) -> PagedRealExecutor:
        """Fresh paged executor per engine (own block pool)."""
        return PagedRealExecutor(model, params, use_kernels=use_kernels)
    return factory


def slot_executor_factory(cfg, model: Optional[DecoderModel] = None,
                          params: Optional[Dict] = None, *, max_slots: int,
                          s_kv: int, chunk_pad: Optional[int] = None,
                          device="cuda") -> Callable:
    """``factory(role) -> RealExecutor``: one slot cache per engine, all
    sharing one copy of the weights; the PPI keeps the paper's 2-slot
    cap. Weights and ``device`` as in :func:`paged_executor_factory`."""
    model, params = _model_on(cfg, model, params, device)

    def factory(role: str) -> RealExecutor:
        """Slot executor; the PPI keeps the paper's 2-slot cap."""
        return RealExecutor(model, params,
                            max_slots=2 if role == "ppi" else max_slots,
                            s_kv=s_kv, chunk_pad=chunk_pad)
    return factory
