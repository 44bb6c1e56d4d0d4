"""Host time of the ``prep`` and ``pick`` phases of the CPI's
``executor.decode`` spans (the port's own spans: block tables and inputs
built in numpy, then the greedy pick over each lane's logits), averaged
over the profiled calls of the window (layer: the paged executor)."""

import program_spans


def read(run):
    """Milliseconds, or None where the program recorded no CPI decode."""
    calls = program_spans.cpi_decodes(run)
    if not calls:
        return None
    return 1e-6 * sum(program_spans.phase_ns(sp, {"prep", "pick"})
                      for sp in calls) / len(calls)
