"""Azure-LLM-inference-style conversation traces (paper §5.1).

The paper replays 1000 conversation traces from Microsoft's Azure LLM
inference trace 2023 (mean input 1014, mean output 247 tokens), sent at a
fixed interval (latency runs) or all at t=0 (max-throughput runs). The trace
file is not redistributable, so we generate statistically matched synthetic
traces: log-normal lengths calibrated to the published means, deterministic
per seed.

Arrival assignment is delegated to :mod:`repro_torch.workloads.arrivals`: pass
``arrival="poisson:6"`` (or any :class:`~repro_torch.workloads.arrivals.
ArrivalProcess`) for open-loop traffic models; the ``interval=`` keyword
survives as a back-compat alias for ``fixed:INTERVAL``. Lengths and
arrivals draw from independent rng streams, so the same seed yields the
same request bodies under every arrival model.
"""
from __future__ import annotations

import copy
from typing import List, Optional, Union

import numpy as np

from repro_torch.core.request import Request
from repro_torch.workloads.arrivals import ArrivalProcess, FixedInterval, \
    parse_arrival

AZURE_CONV_MEAN_IN = 1014
AZURE_CONV_MEAN_OUT = 247

# arrivals draw from their own seed stream ("ARRV") so the length samplers
# below consume exactly the seed's draws regardless of the arrival model
_ARRIVAL_STREAM = 0x41525256

ArrivalLike = Union[ArrivalProcess, str, None]


def _resolve_arrival(arrival: ArrivalLike, interval: float) -> ArrivalProcess:
    if arrival is None:
        return FixedInterval(interval)
    if interval:
        raise ValueError("pass either interval= (back-compat fixed spacing) "
                         "or arrival=, not both")
    return parse_arrival(arrival)


def _arrival_times(arrival: ArrivalLike, interval: float, n: int,
                   seed: int) -> np.ndarray:
    proc = _resolve_arrival(arrival, interval)
    return proc.times(n, np.random.default_rng([_ARRIVAL_STREAM, seed]))


class Trace(List[Request]):
    """A replayable request list.

    Engines mutate requests in place (state, generated tokens, shared
    metrics objects), so handing the same ``Request`` objects to a second
    system silently corrupts its run — the classic aliasing footgun this
    class closes: ``ClusterRuntime.run`` refuses already-replayed
    requests, and ``fresh()`` hands out deep copies so one trace can
    drive any number of systems::

        trace = make_trace(1000)
        a = system_a.run(trace.fresh())
        b = system_b.run(trace.fresh())
    """

    def fresh(self) -> "Trace":
        """Deep copies of every request, safe to replay."""
        return Trace(copy.deepcopy(r) for r in self)


def synth_lengths(n: int, mean: float, sigma: float, rng, lo: int, hi: int):
    """Clipped log-normal lengths with mean ``mean``."""
    mu = np.log(mean) - sigma ** 2 / 2.0    # log-normal with E[X]=mean
    return np.clip(rng.lognormal(mu, sigma, n).astype(int), lo, hi)


def sample_lengths(rng, n: int, *, mean_in: float, mean_out: float,
                   max_in: int, max_out: int, scale: float = 1.0):
    """The shared (input, output) length sampler both trace generators
    draw from: log-normal with σ=1.0 on inputs and σ=0.6 on outputs,
    calibrated so E[in]=mean_in / E[out]=mean_out, clipped to the device-
    survivable range. ``scale`` shrinks everything proportionally for
    CPU-scale functional runs. Consumes exactly two draws from ``rng``
    (inputs first), byte-identical to the seed's inline sampling."""
    ins = synth_lengths(n, mean_in * scale, 1.0, rng,
                        max(int(4 * scale), 2), int(max_in * scale))
    outs = synth_lengths(n, mean_out * scale, 0.6, rng,
                         max(int(2 * scale), 1), int(max_out * scale))
    return ins, outs


def make_trace(n_requests: int = 1000, *, seed: int = 0,
               interval: float = 0.0,
               arrival: ArrivalLike = None,
               mean_in: float = AZURE_CONV_MEAN_IN,
               mean_out: float = AZURE_CONV_MEAN_OUT,
               max_in: int = 8192, max_out: int = 1024,
               vocab_size: int = 32000,
               scale: float = 1.0,
               sessions: Optional[int] = None) -> Trace:
    """``arrival`` names the traffic model (an ``ArrivalProcess`` or a
    spec string such as ``"poisson:6"``); ``interval=I`` is the
    back-compat alias for ``fixed:I`` (0 -> all requests at t=0, the
    max-throughput measurement). ``scale`` shrinks lengths for CPU-scale
    functional runs. ``sessions`` tags requests with conversation ids
    drawn from that many sessions (round-robin), for session-affinity
    routing experiments."""
    rng = np.random.default_rng(seed)
    ins, outs = sample_lengths(rng, n_requests, mean_in=mean_in,
                               mean_out=mean_out, max_in=max_in,
                               max_out=max_out, scale=scale)
    arrivals = _arrival_times(arrival, interval, n_requests, seed)
    reqs = Trace()
    for i in range(n_requests):
        prompt = rng.integers(0, vocab_size, ins[i]).astype(np.int32)
        reqs.append(Request(req_id=f"r{i}", prompt=prompt,
                            output_len=int(outs[i]),
                            arrival=float(arrivals[i]),
                            session=(f"s{i % sessions}" if sessions
                                     else None)))
    return reqs


def make_shared_prefix_trace(n_requests: int = 1000, *, seed: int = 0,
                             interval: float = 0.0,
                             arrival: ArrivalLike = None,
                             n_prefixes: int = 8,
                             prefix_len: int = 512,
                             mean_suffix_in: float = 256,
                             mean_out: float = AZURE_CONV_MEAN_OUT,
                             max_in: int = 4096, max_out: int = 1024,
                             vocab_size: int = 32000,
                             scale: float = 1.0) -> Trace:
    """Multi-tenant shared-prefix workload: each request opens with one of
    ``n_prefixes`` common prefixes (system prompt / few-shot template) of
    ``prefix_len`` tokens, followed by a log-normal unique suffix. The
    prefix id doubles as the session tag, so session- and prefix-affinity
    routers can chase KV locality. This is the workload where block-level
    prefix caching pays: without it every request re-prefills its
    template."""
    rng = np.random.default_rng(seed)
    p_len = max(int(prefix_len * scale), 2)
    prefixes = [rng.integers(0, vocab_size, p_len).astype(np.int32)
                for _ in range(n_prefixes)]
    sfx, outs = sample_lengths(rng, n_requests, mean_in=mean_suffix_in,
                               mean_out=mean_out, max_in=max_in,
                               max_out=max_out, scale=scale)
    groups = rng.integers(0, n_prefixes, n_requests)
    arrivals = _arrival_times(arrival, interval, n_requests, seed)
    reqs = Trace()
    for i in range(n_requests):
        g = int(groups[i])
        suffix = rng.integers(0, vocab_size, sfx[i]).astype(np.int32)
        reqs.append(Request(req_id=f"r{i}",
                            prompt=np.concatenate([prefixes[g], suffix]),
                            output_len=int(outs[i]),
                            arrival=float(arrivals[i]),
                            session=f"p{g}"))
    return reqs
