"""``aggregation_ms``: the host wall of ``build_amg_setup`` per build,
from a synchronise to a synchronise, in milliseconds."""


def read(run):
    spans = run.rec.spans.get("build_amg_setup")
    if not spans:
        return None
    return 1e3 * sum(e - s for s, e in spans) / len(spans)
