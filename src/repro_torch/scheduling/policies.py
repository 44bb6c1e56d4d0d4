"""The shipped batch-composition policies.

``fcfs``     — bit-compatible replica of the seed engine: strict FIFO
               admission (a blocked head blocks everyone behind it),
               conservative full-context KV reservation, and a single
               prefill chunk per iteration (the head PREFILL request).
``sarathi``  — Sarathi-SC-style multi-sequence chunk packing: several
               PREFILL requests share one token budget, admission skips
               past blocked heads, and KV blocks grow lazily with
               preemption-by-recompute on OOM.
``sjf``      — shortest-job-first priority (alias ``priority``): ready
               queue and prefill budget are ordered by remaining work
               (prefill left + output left), and preemption victims are
               the *longest* remaining jobs. Lazy KV like sarathi.
"""
from __future__ import annotations

from typing import List, Sequence

from repro_torch.core.request import Request
from repro_torch.scheduling.base import Scheduler


def _remaining_work(req: Request) -> int:
    """Tokens this request still has to produce/ingest — the SJF key."""
    return req.prefill_remaining + max(req.output_len - len(req.generated), 0)


class FCFSScheduler(Scheduler):
    """First come, first served: the seed engine's behaviour."""
    name = "fcfs"
    default_skip_ahead = False
    default_lazy_kv = False
    max_prefill_seqs = 1           # head-of-slots chunk only, as the seed


class SarathiScheduler(Scheduler):
    """Sarathi-style: pack prefill chunks until the token budget is spent."""
    name = "sarathi"
    default_skip_ahead = True
    default_lazy_kv = True
    max_prefill_seqs = None        # pack chunks until the budget is spent


class SJFScheduler(Scheduler):
    """Shortest remaining job first."""
    name = "sjf"
    default_skip_ahead = True
    default_lazy_kv = True
    max_prefill_seqs = None

    def admission_order(self, queue: Sequence[Request]) -> List[Request]:
        """Queue order for admission: least remaining work first."""
        return sorted(queue, key=lambda r: (_remaining_work(r), r.arrival,
                                            r.req_id))

    def prefill_order(self, cands: List[Request]) -> List[Request]:
        """Order of prefill candidates: least remaining work first."""
        return sorted(cands, key=lambda r: (_remaining_work(r), r.arrival,
                                            r.req_id))

    def victim_order(self, decode: List[Request]) -> List[Request]:
        # longest remaining job pays for the shortest ones
        """Preemption order: most remaining work first."""
        return sorted(decode, key=lambda r: (_remaining_work(r), r.arrival,
                                             r.req_id), reverse=True)


SCHEDULERS = {
    "fcfs": FCFSScheduler,
    "sarathi": SarathiScheduler,
    "sjf": SJFScheduler,
    "priority": SJFScheduler,      # alias
}


def make_scheduler(policy: str, cfg) -> Scheduler:
    """Instantiate the scheduler policy named ``policy``."""
    try:
        cls = SCHEDULERS[policy]
    except KeyError:
        raise KeyError(f"unknown sched policy {policy!r}; "
                       f"choose from {sorted(SCHEDULERS)}") from None
    return cls(cfg)
