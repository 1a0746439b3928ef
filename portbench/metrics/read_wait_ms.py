"""``read_wait_ms``: the total time of the program's ``krylov.read``
spans in one solve: the Krylov loop's device reads (``utils/timing.read``),
each the host waiting on the card, in milliseconds.  Measured in a fresh
process after the window (``program_trace.probe``); nothing off the
card, or from a program with no tracer."""
from portbench.program_trace import probe


def read(run):
    got = probe(run)
    return None if got is None else got.get("read_wait_ms")
