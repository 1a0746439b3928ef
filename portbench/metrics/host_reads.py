"""``host_reads``: the program's ``host_reads`` counter over one build
(``build_amg_setup`` + ``build_hierarchy``): every read of a card tensor
on the host through ``utils/timing.read``.  Measured in a fresh process
after the window (``program_trace.probe``); nothing off the card, or
from a program with no tracer."""
from portbench.program_trace import probe


def read(run):
    got = probe(run)
    return None if got is None else got.get("host_reads")
