"""Host time of ``prefill_chunk`` calls on both engines, between two
synchronises, per 1000 chunk tokens, over the window (layer: the paged
executor)."""


def read(run):
    """Milliseconds per 1000 tokens, or None without a prefill chunk."""
    calls = run.rec.prefill
    tokens = sum(c[1] for c in calls)
    if not tokens:
        return None
    return 1e6 * sum(c[3] for c in calls) / tokens
