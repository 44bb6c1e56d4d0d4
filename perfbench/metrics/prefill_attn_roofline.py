"""The chunked-prefill kernel's share of its roofline: the least time the
card needs for the profiled calls' attention (``counts.prefill_attn`` of
each call's chunk and context, on every layer: operations over 989
TFLOP/s or bytes over 3.35 TB/s, the larger) over the kernel's device
time in the trace (layer: the kernels)."""

import counts
import devtrace


def read(run):
    """Percent, or None when no prefill kernel ran while profiling."""
    calls = [c for c in run.rec.prefill if c[4]]
    if run.trace is None or not calls:
        return None
    secs, n = devtrace.kernel_seconds(run.trace["events"],
                                      devtrace.PREFILL_KERNEL)
    if not n:
        return None
    d = run.dims
    bound = sum(counts.bound_s(*counts.prefill_attn(
        ctx, c, d["h"], d["kvh"], d["hd"]))[0] for _, c, ctx, _, _ in calls)
    return 100.0 * d["n_layers"] * bound / secs
