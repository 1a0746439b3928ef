"""``kcycle_ms``: the host wall of every ``Hierarchy.precondition`` call
in the traced window, each from a synchronise to a synchronise, their
total over their number, in milliseconds."""


def read(run):
    spans = run.rec.spans.get("precondition")
    if not spans:
        return None
    return 1e3 * sum(e - s for s, e in spans) / len(spans)
