"""Observability: structured tracing and Perfetto export (docs/OBSERVABILITY.md)."""
from repro_torch.obs.tracer import Tracer

__all__ = ["Tracer"]
