"""``tail_share``: of the program's ``precondition`` spans in one solve,
the share that is self time of launch-bound levels (``level`` spans less
the ``level`` and ``coarse_solve`` spans inside them) and of
``coarse_solve``, in %.  A level is launch-bound when its SpMV's least
time, ``trace.spmv_floor_bytes`` of its stored values and rows over 3.35
TB/s, is under 5 us, the empty kernel's time.  Measured in a fresh
process after the window (``program_trace.probe``); nothing off the
card, or from a program with no tracer."""
from portbench.program_trace import probe


def read(run):
    got = probe(run)
    return None if got is None else got.get("tail_share")
