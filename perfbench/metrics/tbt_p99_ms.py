"""99th percentile of the gaps between consecutive output tokens of a
request, over every gap whose later token reached the host in the window:
the gap that ``harness.end_to_end`` reads as ``tbt_p99_ms`` (layer: the
engine and its scheduler, which put a prefill chunk of one engine or both
between two decode steps; such a gap holds one chunk or two, so the tail
splits by whether more than one gap in a hundred holds two)."""
import numpy as np


def read(run):
    """Milliseconds, or None when no gap ended in the window."""
    gaps = [b - a for times in run.rec.tokens.values()
            for a, b in zip(times[:-1], times[1:])
            if run.t_open <= b < run.t_close]
    if not gaps:
        return None
    return 1e3 * float(np.percentile(np.asarray(gaps), 99))
