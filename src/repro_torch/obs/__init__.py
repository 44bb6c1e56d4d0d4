"""Observability. :class:`Tracer` is the flight recorder of decisions on
the engines' simulated clocks (docs/OBSERVABILITY.md); :mod:`.host`
records the port's host-clock spans while a ``torch.profiler`` session
is open (``host.session()`` after the profiled steps)."""
from repro_torch.obs import host
from repro_torch.obs.tracer import Tracer

__all__ = ["Tracer", "host"]
