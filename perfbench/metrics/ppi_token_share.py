"""Share of the window's prompt tokens that the PPI prefilled: the sum of
``Request.partial_len`` over the sum of ``input_len``, over every request
due in the window whose prefill finished (its first token came out by
the close), split or not: a request still queued at the close has no
split yet (layer: the Cronus pair and its Balancer)."""


def read(run):
    """Percent, or None when no request of the window got a first token."""
    reqs = [s.req for s in run.window_sent()
            if (run.rec.tokens.get(s.req.req_id) or [run.t_close])[0]
            < run.t_close]
    if not reqs:
        return None
    return 100.0 * sum(r.partial_len for r in reqs) / sum(
        r.input_len for r in reqs)
