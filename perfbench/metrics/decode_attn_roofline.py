"""The paged decode kernel's share of its roofline: the least time the
card needs for the profiled calls' attention (``counts.decode_attn`` of
each call's lanes and contexts, on every layer: bytes over 3.35 TB/s or
operations over 989 TFLOP/s, the larger) over the device time of its
split and merge kernels in the trace (layer: the kernels)."""

import counts
import devtrace


def read(run):
    """Percent, or None when no decode kernel ran while profiling."""
    calls = [c for c in run.rec.decode if c[3]]
    if run.trace is None or not calls:
        return None
    secs, n = devtrace.kernel_seconds(run.trace["events"],
                                      devtrace.DECODE_KERNELS)
    if not n:
        return None
    d = run.dims
    bound = sum(counts.bound_s(*counts.decode_attn(
        lens, d["h"], d["kvh"], d["hd"], d["page"]))[0]
        for _, lens, _, _ in calls)
    return 100.0 * d["n_layers"] * bound / secs
