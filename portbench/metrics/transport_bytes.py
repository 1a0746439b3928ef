"""``transport_bytes``: the bytes rank 0 hands the transport per solve
(``RankComm.sent``, summed over its collectives), averaged over the
window's requests."""


def read(run):
    sent = run.rec.counters.get("transport_bytes")
    return sum(sent) / len(sent) if sent else None
