"""Share of the profiled seconds in which the card ran nothing while the
host was in the ``launch`` phase of one of the port's executor spans
(the innermost open span or phase takes each idle instant; layer: the
device)."""

import program_spans


def read(run):
    """Percent, or None without a device trace or program spans."""
    split = program_spans.idle_split(run)
    if split is None or run.trace["window_s"] <= 0:
        return None
    return 100.0 * split["launch"] / run.trace["window_s"]
