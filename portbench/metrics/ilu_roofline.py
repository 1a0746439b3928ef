"""``ilu_roofline``: the least time of one ILU smoothing application on
the finest level over its measured time, in %.  The least bytes are
``trace.spmv_floor_bytes`` of each SpMV the application makes: per sweep
one with A (the benchmark's matrix's stored values) and ``inner`` each
with L and U, whose stored values are counted where they are nonzero
(not their padded slots), over the published 3.35 TB/s.  The time is
the median of 50 calls of ``Smoother.apply`` (whatever implements it) on
the finest level, each between two CUDA events with L2 evicted before
it.  Nothing without a card, or where the finest level's smoother is not
an ILU."""
import torch

from portbench.trace import roofline_share, spmv_floor_bytes

CALLS = 50


def device_seconds(fn, device: torch.device, calls: int = CALLS) -> float:
    """Median device time of ``fn()``.  Before each call the card evicts
    L2 (a write of twice its size) and spins while the host enqueues the
    call, so no launch gap falls between the events."""
    flush = torch.empty((2 * 50 * 2 ** 20 // 4,), dtype=torch.float32,
                        device=device)
    fn()
    pairs = []
    for _ in range(calls):
        flush.zero_()
        torch.cuda._sleep(200_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize(device)
    times = sorted(s.elapsed_time(e) * 1e-3 for s, e in pairs)
    return times[len(times) // 2]


def stored_nonzeros(ell) -> int:
    return int(((ell.vals != 0) & ell.slot_mask()).sum())


def floor_bytes(system, sm) -> int:
    """The least bytes of one application of ``sm`` on the finest level."""
    width = torch.finfo(system.dtype).bits // 8
    n = system.n
    a = spmv_floor_bytes(system.a.nnz, n, width)
    tri = sum(spmv_floor_bytes(stored_nonzeros(m), n, width)
              for m in (sm.lmat, sm.umat))
    return sm.sweeps * (a + sm.inner_sweeps * tri)


def read(run):
    system = run.system
    if run.device.type != "cuda" or not hasattr(system, "hier"):
        return None
    level = system.hier.levels[0]
    sm = level.smoother
    if getattr(sm, "kind", None) != "ilu0" or sm.lmat is None:
        return None
    apply = type(sm).apply
    npad = level.a.npad
    gen = torch.Generator(device=run.device).manual_seed(0)
    b = torch.rand(npad, dtype=system.dtype, device=run.device,
                   generator=gen)
    x = torch.rand(npad, dtype=system.dtype, device=run.device,
                   generator=gen)
    seconds = device_seconds(lambda: apply(sm, level.a, b, x), run.device)
    return roofline_share(floor_bytes(system, sm), seconds)
