"""Host time of the ``launch`` phase of the CPI's ``executor.decode``
spans (the port's own spans, ``repro_torch.obs.host``: from the first
input sent to the card through the head's last operation), averaged over
the profiled calls of the window (layer: the paged executor)."""

import program_spans


def read(run):
    """Milliseconds, or None where the program recorded no CPI decode."""
    calls = program_spans.cpi_decodes(run)
    if not calls:
        return None
    return 1e-6 * sum(program_spans.phase_ns(sp, {"launch"})
                      for sp in calls) / len(calls)
