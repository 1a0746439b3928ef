"""``host_compute_idle``: of the device's idle time in one request traced
by ``torch.profiler`` (device activity only), the share that falls
inside the program's ``pack.*`` or ``refine.*`` spans (the host pack and
refinement's host work), in %.  The spans are placed on the device's
clock by the tracer's marker, the trace's first event; the request runs
from the marker to the host's stamp after its last synchronise.
Measured in a fresh process after the window (``program_trace.probe``);
nothing off the card, or from a program with no tracer."""
from portbench.program_trace import probe


def read(run):
    got = probe(run)
    return None if got is None else got.get("host_compute_idle")
