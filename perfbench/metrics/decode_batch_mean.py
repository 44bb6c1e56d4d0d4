"""Lanes a CPI ``decode`` call carries, averaged over the window's calls
(layer: the engine and its scheduler, which compose each step's batch)."""


def read(run):
    """Lanes, or None when the CPI decoded nothing in the window."""
    calls = [c for c in run.rec.decode if c[0] == "cpi"]
    if not calls:
        return None
    return sum(len(c[1]) for c in calls) / len(calls)
