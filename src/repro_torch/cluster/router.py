"""Request routers for the cluster runtime: the two that this slice needs.

A router picks, for each arriving request, which endpoint (Cronus pair /
DP worker / disaggregated pool) serves it. ``select`` returns ``None``
when the chosen endpoint cannot take the request yet — the runtime then
retries after engines advance (head-of-line order).

Only :class:`Router` and :class:`RoundRobinRouter` are here, which is what
:meth:`repro_torch.core.cronus.CronusSystem.run` needs. The other policies
of the JAX package's ``cluster/router.py`` (least-loaded, session- and
prefix-affinity, KV-aware) are still to be ported.
"""
from __future__ import annotations

import abc
from typing import List, Optional, Sequence

from repro_torch.cluster.runtime import Endpoint
from repro_torch.core.request import Request


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
