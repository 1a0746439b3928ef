"""``refine_host_ms``: the total time of the program's ``refine.*`` spans
in one request: ``solve_refined``'s float64 residuals on the host and
x's copy back and accumulation, in milliseconds.  Measured in a fresh
process after the window (``program_trace.probe``); nothing off the
card, or from a program with no tracer."""
from portbench.program_trace import probe


def read(run):
    got = probe(run)
    return None if got is None else got.get("refine_host_ms")
