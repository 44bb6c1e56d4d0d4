"""Host time of one PPI->CPI KV handoff: the PPI's ``extract_kv`` plus
the CPI's ``inject_kv``, each between two synchronises, averaged over the
window's calls (layer: the KV handoff)."""


def read(run):
    """Milliseconds, or None when no handoff ran in the window."""
    ex, inj = run.rec.extract, run.rec.inject
    if not ex or not inj:
        return None
    return 1e3 * (sum(ex) / len(ex) + sum(inj) / len(inj))
