"""The whole step's share of the card's bf16 peak: the model operations of
the tokens the executors processed (``counts.model_flops``: two a weight a
token through the layers, the valid attention pairs, the head's rows) over
the host time of the ``service.step`` calls that ran work, times 989
TFLOP/s (layer: the model step)."""

import counts


def read(run):
    """Percent, or None when no step ran work in the window."""
    secs = sum(s for s, _ in run.rec.steps)
    if not secs:
        return None
    flops = sum(f for _, f in run.rec.steps)
    return 100.0 * flops / (secs * counts.PEAK_FLOPS_BF16)
