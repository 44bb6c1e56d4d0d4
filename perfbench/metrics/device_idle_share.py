"""Share of the profiled seconds in which no operation ran on the card:
one minus the union of the device intervals over the window's length
(layer: the device)."""


def read(run):
    """Percent, or None without a device trace."""
    if run.trace is None or run.trace["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - run.trace["busy_s"] / run.trace["window_s"])
