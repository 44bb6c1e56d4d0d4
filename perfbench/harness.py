"""Drive one cell of the benchmark: a Cronus pair of the port serving a
traffic mix on the host clock.

The system under test is ``repro_torch``'s Cronus pair on the
configuration's executor (the paged one unless its ``serving`` names the
slot executor): ``serving.simulator.build_system("cronus", ...)`` with
``paged_executor_factory`` or ``slot_executor_factory``, behind the
endpoint and round-robin router
that ``ServeSpec`` wires for a pair, driven through
``InferenceService.submit`` and ``step``. The engines keep their simulated
A100 (CPI) and A10 (PPI) clocks, which order their iterations and feed the
Balancer; no time this module reports comes from them. Every time is the
host clock (``time.perf_counter``):

- a request is handed to ``submit`` when it is due on the host clock, with
  the service's simulated "now" as its ``arrival``, so it is routed on the
  next ``step`` that has room for it;
- each engine's ``on_token`` is wrapped on the instance, so every emitted
  token gets the host time at which it reached the host (the executors'
  ``prefill_chunk`` and ``decode`` end with ``.cpu()``), and each
  executor's ``prefill_chunk`` is counted with the host time it returned;
- with ``trace``, the executors' ``prefill_chunk``, ``decode``,
  ``extract_kv`` and ``inject_kv`` are wrapped too, each call timed
  between two ``torch.cuda.synchronize()``, and the last seconds of the
  window run under ``torch.profiler`` (CUDA activity).

The loop runs ``warmup_s`` seconds of the mix before the window opens, so
the window starts from the loop's steady state.

The model reaches the harness only through its family
(``families/<family>.py``, named by the configuration): its sizes, the
port's config, the weights, the operations ``step_mfu`` counts and the
plain reference that decides ``correct``.
"""
from __future__ import annotations

import gc
import importlib.util
import json
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

import check
import counts
import devtrace
import traffic as traffic_mod

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
PROFILE_S = 5.0          # seconds of the window (its end) under the profiler
DEFAULT_FAMILY = "dense"  # the family of a configuration that names none


def checkout_caches() -> None:
    """Keep every build and kernel cache of the run in the checkout, at
    fixed paths (the CUDA kernels go to ``build/kernels/``, where the
    port's ``kernels/build.py`` puts them)."""
    import os
    build = ROOT / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(build / "cuda_cache")


# ---------------------------------------------------------------------------
# the cell's files
# ---------------------------------------------------------------------------

@dataclass
class Cell:
    """One workload of ``BENCHMARK.json`` with its configuration file, its
    traffic mix, the metrics it reports, and its configuration's family
    module with that family's plain reference."""
    name: str
    config: Dict
    mix: Dict
    limits: Dict
    end_to_end: List[Dict]
    per_layer: List[Dict]
    family: object
    reference: object


def _load_file(path: Path, module_name: str):
    """The Python file ``path`` loaded as a module named ``module_name``."""
    spec = importlib.util.spec_from_file_location(module_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_family(name: str, where: Path):
    """The family module ``<where>/<name>.py`` and the module of its plain
    reference (the file its ``reference`` names, beside the module)."""
    path = where / f"{name}.py"
    if not path.is_file():
        raise SystemExit(f"the configuration names model family {name!r}, "
                         f"but there is no family module {path}")
    family = _load_file(path, f"perfbench_family_{name}")
    ref = (where / family.reference).resolve()
    if not ref.is_file():
        raise SystemExit(f"model family {name!r} names its reference "
                         f"{family.reference!r}, but there is no file {ref}")
    return family, _load_file(ref, f"perfbench_reference_{name}")


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` as ``BENCHMARK.json`` and the files it names
    define it: ``configs[].file``, ``perfbench/traffic/<traffic>.json``,
    ``perfbench/limits/<workload>.json`` and the family module
    ``perfbench/families/<family>.py`` of the configuration's ``family``
    (``dense`` where it names none)."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; known: "
                         f"{sorted(cells)}")
    w = cells[name]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = json.loads((root / cfg_entry["file"]).read_text())
    mix = json.loads((HERE / "traffic" / f"{w['traffic']}.json").read_text())
    limits = json.loads((HERE / "limits" / f"{name}.json").read_text())

    def mine(m):
        return "workloads" not in m or name in m["workloads"]
    e2e = [m for m in bench["end_to_end"] if mine(m)]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if ("workloads" in m and name in m["workloads"])
                 or ("workloads" not in m and m["moves"] in reported)]
    family, reference = load_family(config.get("family", DEFAULT_FAMILY),
                                    root / "perfbench" / "families")
    return Cell(name, config, mix, limits, e2e, per_layer, family,
                reference)


def model_dims(config: Dict) -> Dict:
    """The sizes the counts and the reference read, from a configuration
    file (its published keys, as run)."""
    d = config["hidden_size"]
    h = config["num_attention_heads"]
    return {"n_layers": config["num_hidden_layers"], "d": d, "h": h,
            "kvh": config["num_key_value_heads"],
            "hd": config.get("head_dim", d // h),
            "d_ff": config["intermediate_size"],
            "vocab": config["vocab_size"],
            "rope_theta": float(config["rope_theta"]),
            "eps": float(config["rms_norm_eps"]),
            "page": config["serving"]["block_size"]}


def port_config(config: Dict, dims: Dict):
    """The port's ``ModelConfig``: the registry's arch with the sizes of
    the configuration file."""
    import dataclasses
    from repro_torch.configs import get_config
    return dataclasses.replace(
        get_config(config["arch"]), n_layers=dims["n_layers"],
        d_model=dims["d"], n_heads=dims["h"], n_kv_heads=dims["kvh"],
        head_dim=dims["hd"], d_ff=dims["d_ff"], vocab_size=dims["vocab"],
        rope_theta=dims["rope_theta"], norm_eps=dims["eps"],
        tie_embeddings=False, dtype=config["torch_dtype"])


def build_service(cfg, params: Dict, serving: Dict, device,
                  use_kernels: Optional[bool] = None):
    """A Cronus pair of executors sharing ``params``, as an
    ``InferenceService`` with the pair's endpoint and router. The
    executor is ``serving["executor"]``: ``"paged"`` (the default; KV in
    a pool of ``num_kv_blocks`` blocks an engine, the CUDA kernels on the
    card unless ``use_kernels`` says otherwise) or ``"real"`` (the slot
    executor, which serves every family of the port: ``s_kv`` positions a
    slot)."""
    from repro_torch.cluster.router import RoundRobinRouter
    from repro_torch.models.transformer import DecoderModel
    from repro_torch.serving.api import (InferenceService,
                                         paged_executor_factory,
                                         slot_executor_factory)
    from repro_torch.serving.hardware import DEVICES
    from repro_torch.serving.simulator import build_system
    # MoE layers drop no token, as the port's serving builds run them
    model = DecoderModel(cfg, params, device=device, exact_moe=True)
    executor = serving.get("executor", "paged")
    if executor == "paged":
        factory = paged_executor_factory(cfg, model, params, device=device,
                                         use_kernels=use_kernels)
    elif executor == "real":
        factory = slot_executor_factory(cfg, model, params, device=device,
                                        max_slots=serving["max_slots"],
                                        s_kv=serving["s_kv"])
    else:
        raise SystemExit(f"serving executor {executor!r}: the benchmark "
                         f"runs 'paged' or 'real'")
    system = build_system(
        "cronus", cfg, DEVICES[serving["hi"]], DEVICES[serving["lo"]],
        max_slots=serving["max_slots"], block_size=serving["block_size"],
        max_batched_tokens=serving["max_batched_tokens"],
        sched_policy=serving["sched_policy"],
        num_kv_blocks=serving.get("num_kv_blocks"), executor=executor,
        executor_factory=factory)
    return InferenceService([system.endpoint()], RoundRobinRouter(),
                            cfg=cfg, system=system)


# ---------------------------------------------------------------------------
# recording on the host clock
# ---------------------------------------------------------------------------

@dataclass
class Record:
    """What the harness saw: host times of tokens, and with ``trace`` the
    executor calls and steps of the window."""
    tokens: Dict[str, List[float]] = field(default_factory=dict)
    finished: List = field(default_factory=list)
    on: bool = False               # the window is open
    profiling: bool = False        # the profiler is on
    prefill: List = field(default_factory=list)   # (engine, c, ctx, s, prof)
    decode: List = field(default_factory=list)    # (engine, lens, s, prof)
    prefilled: List = field(default_factory=list)  # (host time, tokens)
    extract: List[float] = field(default_factory=list)
    inject: List[float] = field(default_factory=list)
    steps: List = field(default_factory=list)     # (s, flops)
    kv_peaks: Dict = field(default_factory=dict)  # engine: (reserved, live)
    spans: List = field(default_factory=list)     # (t0, t1, label)
    step_flops: int = 0


def _wrap_tokens(service, rec: Record) -> None:
    for eng in service.engines:
        inner = eng.on_token

        def on_token(req, token, clock, _inner=inner):
            rec.tokens.setdefault(req.req_id, []).append(time.perf_counter())
            if _inner is not None:
                _inner(req, token, clock)
            if req.done:
                rec.finished.append(req)
        eng.on_token = on_token


def _count_prefill(service, rec: Record) -> None:
    """Count the prompt tokens of each ``prefill_chunk`` call in the
    window, with the host time the call returned."""
    for eng in service.engines:
        ex = eng.executor

        def prefill_chunk(slot, tokens, *args, _f=ex.prefill_chunk,
                          **kwargs):
            out = _f(slot, tokens, *args, **kwargs)
            if rec.on:
                rec.prefilled.append((time.perf_counter(), len(tokens)))
            return out
        ex.prefill_chunk = prefill_chunk


def _kv_peaks(service, peaks: Dict) -> None:
    """Raise each engine's peaks of KV blocks reserved (the allocator's)
    and live (the residents' context) to what they hold now."""
    for eng in service.engines:
        alloc = eng.allocator
        reserved = alloc.num_blocks - alloc.num_free
        live = sum(-(-r.context_len // alloc.block_size)
                   for r in eng.slots if r is not None)
        old = peaks.get(eng.name, (0, 0))
        peaks[eng.name] = (max(old[0], reserved), max(old[1], live))


def _wrap_executors(service, rec: Record, dims: Dict, sync: Callable,
                    model_flops: Callable) -> None:
    """Time each executor call between two synchronises and count the
    work it needs (the model's operations, for ``step_mfu``, by the
    family's ``model_flops``)."""

    def timed(fn, label):
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        t1 = time.perf_counter()
        if rec.profiling:
            rec.spans.append((t0, t1, label))
        return out, t1 - t0

    for eng in service.engines:
        ex, name = eng.executor, eng.name

        def prefill_chunk(slot, tokens, ctx_len, completes, enc_emb=None,
                          _f=ex.prefill_chunk, _n=name):
            out, s = timed(lambda: _f(slot, tokens, ctx_len, completes,
                                      enc_emb=enc_emb),
                           f"executor.prefill_chunk ({_n})")
            c = len(tokens)
            rec.step_flops += model_flops(
                dims, tokens=c, attn_pairs=counts.causal_pairs(ctx_len, c),
                head_rows=1 if completes else 0)
            if rec.on:
                rec.prefill.append((_n, c, int(ctx_len), s, rec.profiling))
            return out

        def decode(slot_tokens, slot_lens, _f=ex.decode, _n=name):
            out, s = timed(lambda: _f(slot_tokens, slot_lens),
                           f"executor.decode ({_n})")
            lens = tuple(int(v) + 1 for v in slot_lens.values())
            rec.step_flops += model_flops(
                dims, tokens=len(lens), attn_pairs=sum(lens),
                head_rows=len(lens))
            if rec.on:
                rec.decode.append((_n, lens, s, rec.profiling))
            return out

        def extract_kv(slot, upto, _f=ex.extract_kv):
            out, s = timed(lambda: _f(slot, upto), "executor.extract_kv")
            if rec.on:
                rec.extract.append(s)
            return out

        def inject_kv(slot, payload, upto, _f=ex.inject_kv):
            out, s = timed(lambda: _f(slot, payload, upto),
                           "executor.inject_kv")
            if rec.on:
                rec.inject.append(s)
            return out

        ex.prefill_chunk, ex.decode = prefill_chunk, decode
        ex.extract_kv, ex.inject_kv = extract_kv, inject_kv


# ---------------------------------------------------------------------------
# the loop
# ---------------------------------------------------------------------------

@dataclass
class Sent:
    """One request the harness handed to the service."""
    req: object
    due: float
    sent: float


def drive(service, traffic: traffic_mod.Traffic, rec: Record, *,
          warmup_s: float, seconds: float, trace: bool):
    """Run the mix for ``warmup_s`` then the window of ``seconds``; returns
    the requests sent, the window's host times and the profiler (or
    None). With ``trace``, each ``service.step`` that ran work is timed and
    the last ``PROFILE_S`` seconds of the window run under the profiler."""
    from repro_torch.core.request import Request
    sent: List[Sent] = []
    t_start = time.perf_counter()
    t_open = t_start + warmup_s
    t_close = t_open + seconds
    t_prof = max(t_open, t_close - PROFILE_S)
    prof = None

    def submit(tokens, out_len, due):
        req = Request(f"r{len(sent)}", tokens, out_len,
                      arrival=service.now)
        service.submit(req)
        sent.append(Sent(req, due, time.perf_counter()))

    due_q: List[float] = []
    if traffic.closed:
        for tokens, out_len in traffic.steady_start(traffic.mix["clients"]):
            submit(tokens, out_len, t_start)
        plan = []
    else:
        plan = traffic.schedule(warmup_s, seconds)
    k = 0

    while True:
        now = time.perf_counter()
        if now >= t_close:
            break
        if not rec.on and now >= t_open:
            rec.on = True
        if trace and prof is None and now >= t_prof:
            prof = devtrace.profiler()
            prof.__enter__()
            rec.profiling = True
        for t_done in due_q:
            n_in, out_len = traffic.lengths()
            submit(traffic.tokens(n_in), out_len, t_done)
        due_q.clear()
        while k < len(plan) and t_start + plan[k][0] <= now:
            due, n_in, out_len = plan[k]
            submit(traffic.tokens(n_in), out_len, t_start + due)
            k += 1
        if service.n_active == 0:
            wake = t_start + plan[k][0] if k < len(plan) else t_close
            time.sleep(max(0.0, min(wake, t_close) - time.perf_counter()))
            continue
        rec.step_flops = 0
        t0 = time.perf_counter()
        progressed = service.step()
        t1 = time.perf_counter()
        _kv_peaks(service, rec.kv_peaks)
        if trace and rec.on and rec.step_flops:
            rec.steps.append((t1 - t0, rec.step_flops))
            if rec.profiling:
                rec.spans.append((t0, t1, "service.step"))
        if traffic.closed and rec.finished:
            due_q.extend([t1] * len(rec.finished))
        rec.finished.clear()
        if not progressed:
            time.sleep(0.001)
    if prof is not None:
        prof.__exit__(None, None, None)
        rec.profiling = False
    return sent, t_open, t_close, prof


# ---------------------------------------------------------------------------
# end-to-end readings (host clock)
# ---------------------------------------------------------------------------

def percentile(values, p: float) -> float:
    """``p``-th percentile, linear interpolation (``core/metrics.py``'s
    arithmetic); NaN when empty."""
    if not len(values):
        return float("nan")
    return float(np.percentile(np.asarray(values), p))


def end_to_end(sent: List[Sent], rec: Record, t_open: float,
               t_close: float) -> Dict:
    """TTFT of every request due in the window (one with no first token by
    the close counts its wait to the close), every gap between consecutive
    tokens whose later token falls in the window, the output tokens
    emitted in the window, and the tokens served in it: those output
    tokens plus the prompt tokens that the executors' prefill chunks (of
    either engine) processed in the window."""
    ttft, gaps, n_tokens, tail = [], [], 0, []
    n_prompt = sum(n for t, n in rec.prefilled if t_open <= t < t_close)
    for s in sent:
        times = rec.tokens.get(s.req.req_id, [])
        if t_open <= s.due < t_close:
            first = times[0] if times and times[0] < t_close else t_close
            ttft.append(first - s.due)
            tail.append((round(first - s.due, 4), s.req.input_len,
                         round(s.due - t_open, 3)))
    for times in rec.tokens.values():
        for a, b in zip(times[:-1], times[1:]):
            if t_open <= b < t_close:
                gaps.append(b - a)
        n_tokens += sum(1 for t in times if t_open <= t < t_close)
    window = t_close - t_open
    late = [s.sent - s.due for s in sent if t_open <= s.due < t_close]

    def backlog(t):
        """Requests due by ``t`` without a first token by then."""
        n = 0
        for s in sent:
            times = rec.tokens.get(s.req.req_id)
            if s.due <= t and not (times and times[0] <= t):
                n += 1
        return n
    return {
        "ttft_p90_s": percentile(ttft, 90),
        "ttft_p50_s": percentile(ttft, 50),
        "tbt_p99_ms": 1e3 * percentile(gaps, 99),
        "tbt_p50_ms": 1e3 * percentile(gaps, 50),
        "out_tokens_per_s": n_tokens / window,
        "tokens_per_s": (n_prompt + n_tokens) / window,
        "n_ttft": len(ttft), "n_gaps": len(gaps), "n_tokens": n_tokens,
        "n_prompt_tokens": n_prompt,
        "no_first_token": sum(1 for s in sent if t_open <= s.due < t_close
                              and not rec.tokens.get(s.req.req_id)),
        "lateness_max_s": max(late) if late else 0.0,
        "lateness_mean_s": float(np.mean(late)) if late else 0.0,
        "backlog_open": backlog(t_open), "backlog_close": backlog(t_close),
        "sent": len(sent),
        # the ten longest waits: (TTFT s, prompt tokens, due s into the window)
        "ttft_tail": sorted(tail, reverse=True)[:10],
    }


def free_program(service) -> None:
    """Drop the program's state (engines, executors, KV pools) and hand
    its memory back before the reference runs."""
    for eng in service.engines:
        ex = eng.executor
        for key in ("k_pool", "v_pool", "cache"):
            if hasattr(ex, key):
                setattr(ex, key, None)
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# one run of a cell
# ---------------------------------------------------------------------------

@dataclass
class Run:
    """What a per-layer metric's reader reads."""
    dims: Dict
    sent: List[Sent]
    t_open: float
    t_close: float
    rec: Record
    trace: Optional[Dict]

    def window_sent(self) -> List[Sent]:
        """The requests due in the window."""
        return [s for s in self.sent if self.t_open <= s.due < self.t_close]


def reader(metric: str):
    """The reader of a per-layer metric: ``metrics/<name>.py``, else the
    file of the quantity it splits (the name before its first dot)."""
    for stem in (metric, metric.split(".")[0]):
        path = HERE / "metrics" / f"{stem}.py"
        if path.exists():
            return _load_file(
                path, f"perfbench_metric_{stem.replace('.', '_')}").read
    raise SystemExit(f"no reader for per-layer metric {metric!r}")


def _sync_for(device) -> Callable:
    if torch.device(device).type == "cuda":
        return torch.cuda.synchronize
    return lambda: None


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, *,
             device="cuda", process_start: float,
             use_kernels: Optional[bool] = None,
             fault: Optional[Callable] = None,
             control: bool = False) -> Dict:
    """One run: set-up, warm-up, the window, then the comparison with the
    reference. Returns the result line's fields plus ``info`` (earlier
    output) and ``checks`` (each compared number beside its limit).
    ``fault`` breaks the built service before the run, and ``control``
    adds the fp8 control's reading of the same sample (tests and
    ``control.py`` only; the benchmark's runs take neither)."""
    family = cell.family
    dims = family.dims(cell.config)
    cfg = family.port_config(cell.config, dims)
    on_card = torch.device(device).type == "cuda"
    if on_card:
        from repro_torch.kernels import build
        for source in build.SOURCES:
            build.load(source)
        if trace:
            # the profiler's first start takes seconds: pay it in set-up
            with devtrace.profiler():
                torch.ones(1, device=device).add_(1)
                torch.cuda.synchronize()
    params = family.make_params(dims, seed, device,
                                getattr(torch, cell.config["torch_dtype"]))
    service = build_service(cfg, params, cell.config["serving"], device,
                            use_kernels)
    if fault is not None:
        fault(service)
    rec = Record()
    _wrap_tokens(service, rec)
    if trace:
        _wrap_executors(service, rec, dims, _sync_for(device),
                        family.model_flops)
    _count_prefill(service, rec)
    mix = cell.mix
    tr = traffic_mod.Traffic(mix, seed, dims["vocab"])
    if on_card:
        torch.cuda.synchronize()
    sent, t_open, t_close, prof = drive(
        service, tr, rec,
        warmup_s=mix["warmup_s"], seconds=seconds, trace=trace)
    setup_s = t_open - process_start
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    e2e = end_to_end(sent, rec, t_open, t_close)
    e2e["setup_s"] = setup_s

    metrics: Dict[str, Dict] = {}
    device_info: Dict = {}
    breakdown = None
    if trace:
        trace_info = devtrace.read(prof, rec.spans) if prof else None
        run = Run(dims, sent, t_open, t_close, rec, trace_info)
        for m in cell.per_layer:
            value = reader(m["name"])(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        if trace_info is not None:
            device_info = {"busy_s": trace_info["busy_s"],
                           "window_s": trace_info["window_s"]}
            breakdown = {"device_ops": [list(x) for x in
                                        trace_info["device_ops"]],
                         "idle_gaps": [list(x) for x in
                                       trace_info["idle_gaps"]]}
        del run, trace_info
    else:
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    prof = None

    # the comparison, once the window has closed and the program is freed
    finished = [(s.req.prompt, list(s.req.generated)) for s in sent
                if s.req.done]
    picked = [finished[i] for i in check.sample(finished, seed)]
    attempted = sum(1 for s in sent if t_open <= s.due < t_close)
    kv_peaks = rec.kv_peaks
    for s in sent:
        s.req.kv_payload = None
    free_program(service)
    del service, rec, sent
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    reading = (check.served_gap(cell.reference.served_logits, params,
                                dims, picked, device, control)
               if picked else {"gap_max": float("inf"), "tokens": 0})
    limit = float(cell.limits["logit_gap_max"]["limit"])
    correct = bool(reading["tokens"] > 0 and reading["gap_max"] <= limit)
    checks = {"logit_gap_max": {"value": reading["gap_max"],
                                "limit": limit}}
    pool = cell.config["serving"].get("num_kv_blocks")
    info = dict(e2e, kv_blocks={"pool": pool, **{
        k: list(v) for k, v in kv_peaks.items()}},
                requests_checked=len(picked),
                tokens_checked=reading["tokens"], finished=len(finished),
                served_max=max((len(t) for _, t in picked), default=0))
    if control:
        info["control_gap_max"] = reading.get("control_gap_max")
    out = {"correct": correct, "attempted": attempted,
           "failed": 0 if correct else len(picked),
           "metrics": metrics,
           "device": dict(platform="gpu" if on_card else "cpu",
                          kind=(torch.cuda.get_device_name(0) if on_card
                                else "cpu"),
                          count=1, memory_peak_bytes=int(peak),
                          **device_info)}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["info"] = info
    out["checks"] = checks
    return out
