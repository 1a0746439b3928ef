"""``spmv_roofline``: the least time of the finest level's SpMV over its
measured time, in %.  The least time counts each stored value of the
benchmark's matrix once at the configuration's dtype, x once and y once
at the logical row count, over the published 3.35 TB/s; the time is the
median of 50 calls of ``Hierarchy.matvec`` (whatever implements it),
each between two CUDA events with L2 evicted before it.  Nothing without
a card."""
import torch

from portbench.trace import roofline_share, spmv_floor_bytes

CALLS = 50


def matvec_seconds(hier, x, calls: int = CALLS) -> float:
    """Median device time of ``Hierarchy.matvec`` (the class's own, not a
    traced wrapper) on ``x``.  Before each call the card evicts L2 (a
    write of twice its size) and spins while the host enqueues the call,
    so no launch gap falls between the events."""
    matvec = type(hier).matvec
    flush = torch.empty((2 * 50 * 2 ** 20 // 4,), dtype=torch.float32,
                        device=x.device)
    matvec(hier, x)
    pairs = []
    for _ in range(calls):
        flush.zero_()
        torch.cuda._sleep(200_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        matvec(hier, x)
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize(x.device)
    times = sorted(s.elapsed_time(e) * 1e-3 for s, e in pairs)
    return times[len(times) // 2]


def read(run):
    system = run.system
    if run.device.type != "cuda" or not hasattr(system, "hier"):
        return None
    hier = system.hier
    x = torch.rand(hier.levels[0].a.npad, dtype=system.dtype,
                   device=run.device)
    seconds = matvec_seconds(hier, x)
    floor = spmv_floor_bytes(system.a.nnz, system.n,
                             torch.finfo(system.dtype).bits // 8)
    return roofline_share(floor, seconds)
