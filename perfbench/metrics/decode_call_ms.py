"""Host time of a CPI ``decode`` call, between two synchronises, averaged
over the window's calls (layer: the paged executor)."""


def read(run):
    """Milliseconds, or None when the CPI decoded nothing in the window."""
    calls = [c for c in run.rec.decode if c[0] == "cpi"]
    if not calls:
        return None
    return 1e3 * sum(c[2] for c in calls) / len(calls)
