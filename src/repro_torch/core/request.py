"""Request lifecycle for the serving engines."""
from __future__ import annotations

import dataclasses
import enum
from typing import Any, List, Optional

import numpy as np

from repro_torch.core.metrics import RequestMetrics


class ReqState(enum.Enum):
    """Lifecycle state of a request on one engine."""
    WAITING = "waiting"        # in a queue, no cache slot
    TRANSFER = "transfer"      # admitted; KV payload arriving (Cronus/disagg)
    PREFILL = "prefill"        # chunked prefill in progress
    RUNNING = "running"        # decoding
    FINISHED = "finished"
    CANCELLED = "cancelled"    # aborted mid-flight (slots/KV blocks freed)


@dataclasses.dataclass
class Request:
    """One inference request plus its per-engine bookkeeping."""
    req_id: str
    prompt: np.ndarray                    # int32 [L_in]
    output_len: int
    arrival: float = 0.0
    enc_emb: Optional[np.ndarray] = None  # whisper-style encoder inputs (stub)
    session: Optional[str] = None         # conversation id (router affinity)

    # Cronus bookkeeping
    partial_len: int = 0                  # tokens prefilled by the PPI
    kv_payload: Any = None                # extracted cache slices in transit
    first_token: Optional[int] = None     # produced by PPI if partial == full
    local_payload: bool = False           # payload stays on-device (offload)
    kv_src: Optional[str] = None          # pool the payload was extracted from

    # engine-local state
    ready_time: float = 0.0               # earliest time this engine may run it
    state: ReqState = ReqState.WAITING
    slot: Optional[int] = None
    context_len: int = 0                  # tokens resident in this engine's cache
    generated: List[int] = dataclasses.field(default_factory=list)
    preempted: bool = False               # ever preempted (recompute pending/done)
    metrics: Optional[RequestMetrics] = None

    def __post_init__(self):
        self.prompt = np.asarray(self.prompt, np.int32)
        if self.metrics is None:
            self.metrics = RequestMetrics(self.req_id, self.arrival,
                                          len(self.prompt), self.output_len)

    @property
    def input_len(self) -> int:
        """Prompt length in tokens."""
        return int(len(self.prompt))

    @property
    def prefill_remaining(self) -> int:
        """Prompt tokens not yet in this engine's cache."""
        return max(self.input_len - self.context_len, 0)

    @property
    def done(self) -> bool:
        """Whether every output token has been generated."""
        return len(self.generated) >= self.output_len

    @property
    def total_ctx(self) -> int:
        """Context length during decode (prompt + generated so far)."""
        return self.input_len + len(self.generated)
