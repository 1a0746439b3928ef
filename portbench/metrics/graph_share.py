"""``graph_share``: of three ``Hierarchy.precondition`` calls (the
class's own, not a traced wrapper) on the window's hierarchy, the share
that replayed a captured CUDA graph (the program's ``kcycle.replay``
counter under an installed ``utils/timing`` tracer), in %.  Nothing
off the card, or from a program with no such counter."""
import torch

from portbench.trace import sync

CALLS = 3
COUNTERS = ("kcycle.eager", "kcycle.capture", "kcycle.replay")


def read(run):
    from multigridsolver_tpu_torch.utils import timing
    system = run.system
    if (run.device.type != "cuda" or not hasattr(system, "hier")
            or not hasattr(timing, "tracing")):
        return None
    hier = system.hier
    precondition = type(hier).precondition
    r = torch.rand(hier.levels[0].a.npad, dtype=system.dtype,
                   device=run.device)
    tracer = timing.PhaseTimer(device=run.device)
    with timing.tracing(tracer):
        for _ in range(CALLS):
            precondition(hier, r)
    sync(run.device)
    if not any(name in tracer.counters for name in COUNTERS):
        return None
    return 100.0 * tracer.counters.get("kcycle.replay", 0) / CALLS
