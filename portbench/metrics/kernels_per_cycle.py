"""``kernels_per_cycle``: device operations per ``Hierarchy.precondition``
call (the class's own, not a traced wrapper), counted by the profiler
over three calls on the window's hierarchy, after one call outside the
profile.  Nothing without a card."""
import torch

from portbench.trace import device_events, sync

CALLS = 3


def read(run):
    from torch.profiler import ProfilerActivity, profile
    system = run.system
    if run.device.type != "cuda" or not hasattr(system, "hier"):
        return None
    hier = system.hier
    precondition = type(hier).precondition
    r = torch.rand(hier.levels[0].a.npad, dtype=system.dtype,
                   device=run.device)
    precondition(hier, r)
    sync(run.device)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(CALLS):
            precondition(hier, r)
        sync(run.device)
    return len(device_events(prof)) / CALLS
