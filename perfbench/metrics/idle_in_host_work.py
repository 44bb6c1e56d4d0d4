"""Share of the profiled seconds in which the card ran nothing while the
host was inside one of the port's spans but not in a ``launch`` phase:
the executor's ``prep``, ``readback`` and ``pick``, and the self time of
``engine.step``, ``pair.submit`` and ``runtime.tick`` (the innermost open
span or phase takes each idle instant; layer: the device)."""

import program_spans


def read(run):
    """Percent, or None without a device trace or program spans."""
    split = program_spans.idle_split(run)
    if split is None or run.trace["window_s"] <= 0:
        return None
    return 100.0 * split["host_work"] / run.trace["window_s"]
