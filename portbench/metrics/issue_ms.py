"""``issue_ms``: the mean host time of the program's ``precondition``
spans (``Hierarchy.precondition``) in one solve, each two stamps of the
host's clock with no synchronise: the time to enqueue one K-cycle, in
milliseconds.  Near ``kcycle_ms``, the host paces the solve.  Measured in
a fresh process after the window (``program_trace.probe``); nothing off
the card, or from a program with no tracer."""
from portbench.program_trace import probe


def read(run):
    got = probe(run)
    return None if got is None else got.get("issue_ms")
