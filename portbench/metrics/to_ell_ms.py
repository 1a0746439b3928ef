"""``to_ell_ms``: the host wall of ``to_ell`` (the host pack and its
copy to the card) per request, ending in a synchronise, in
milliseconds."""


def read(run):
    spans = run.rec.spans.get("to_ell")
    if not spans:
        return None
    return 1e3 * sum(e - s for s, e in spans) / len(spans)
