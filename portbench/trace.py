"""What a traced run records, and the arithmetic the readers share.

:class:`Record` holds the harness's own spans (host walls around its
calls into each layer, each ending in a synchronise when tracing is on)
and counters (one value per request).  :func:`profile_request` runs one
request under ``torch.profiler`` with device activity only and reduces
its trace to the busy time, the traced window, the device operations
that took most time and the longest idle gaps, each named by the span
the host was in.  :func:`busy_seconds` is the union of device intervals
(a copy of the program's ``utils/phase_profile._busy_us`` arithmetic);
:func:`spmv_floor_bytes` is the roofline's byte count.
"""
from __future__ import annotations

import time
from collections import defaultdict
from contextlib import contextmanager

import torch

# published HBM3 bandwidth of one H100 SXM (NVIDIA's data sheet), bytes/s
H100_PEAK_BYTES_S = 3.35e12


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Record:
    """Spans and counters of one run; spans are kept only when
    ``traced`` (each then ends in a synchronise).  Inside
    :meth:`stamping` a span takes two host stamps and no synchronise,
    into ``stamps``: what the host was doing, at no cost to the device's
    schedule."""

    def __init__(self, device: torch.device, traced: bool):
        self.device, self.traced = device, traced
        self.spans: dict[str, list[tuple[float, float]]] = defaultdict(list)
        self.stamps: dict[str, list[tuple[float, float]]] = defaultdict(list)
        self.counters: dict[str, list[float]] = defaultdict(list)
        self._stamping = False

    @contextmanager
    def stamping(self):
        self._stamping = True
        try:
            yield
        finally:
            self._stamping = False

    @contextmanager
    def span(self, name: str):
        if self._stamping:
            t0 = time.perf_counter()
            try:
                yield
            finally:
                self.stamps[name].append((t0, time.perf_counter()))
            return
        if not self.traced:
            yield
            return
        sync(self.device)
        t0 = time.perf_counter()
        try:
            yield
        finally:
            sync(self.device)
            self.spans[name].append((t0, time.perf_counter()))

    def wrap(self, name: str, fn):
        """``fn`` with every call inside a span ``name``."""
        def wrapped(*args, **kw):
            with self.span(name):
                return fn(*args, **kw)
        return wrapped

    def count(self, name: str, value: float) -> None:
        self.counters[name].append(float(value))


def busy_seconds(intervals) -> float:
    """Length of the union of ``(start, end)`` intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def idle_gaps(intervals) -> list[tuple[float, float]]:
    """The gaps between the union's segments, as (start, end)."""
    gaps, end = [], None
    for s, e in sorted(intervals):
        if end is not None and s > end:
            gaps.append((end, s))
        end = e if end is None else max(end, e)
    return gaps


def device_events(prof) -> list:
    """The device operations (kernels, copies, sets) of a profile."""
    return [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]


def is_transport(name: str) -> bool:
    """Whether a device operation is the transport's (NCCL's kernels,
    which occupy the device while they wait for a peer)."""
    return name.startswith("nccl")


def busy_split(names: list[str], intervals) -> tuple[float, float]:
    """The union of every operation's interval, and of those that are
    not the transport's."""
    compute = [t for n, t in zip(names, intervals) if not is_transport(n)]
    return busy_seconds(intervals), busy_seconds(compute)


def profile_request(run_one, device: torch.device, rec: Record) -> dict:
    """One request (``run_one()``) under the profiler, device activity
    only, with the harness's spans stamping the host's clock and never
    synchronising (:meth:`Record.stamping`).  The traced window is its
    host wall, from a synchronise to a synchronise.  A tiny marker
    launched right after the first one is the first device event, which
    places the host's stamps on the device's clock to within a launch's
    latency.  ``busy_s`` is the union of every device operation;
    ``compute_busy_s`` leaves out the transport's kernels, so the time
    the device spends waiting on a peer reads as idle."""
    from torch.profiler import ProfilerActivity, profile
    marker = torch.zeros((1,), device=device)
    rec.stamps.clear()
    with profile(activities=[ProfilerActivity.CUDA]) as prof, \
            rec.stamping():
        sync(device)
        t0 = time.perf_counter()
        marker.add_(1.0)
        run_one()
        sync(device)
        window = time.perf_counter() - t0
    events = device_events(prof)
    iv = [(e.time_range.start * 1e-6, e.time_range.end * 1e-6)
          for e in events]
    busy, compute_busy = busy_split([e.name for e in events], iv)
    out = dict(window_s=window, busy_s=busy, compute_busy_s=compute_busy,
               kernels=len(iv), device_ops=[], idle_gaps=[])
    if not iv:
        return out
    by_name = defaultdict(float)
    for e, (s, t) in zip(events, iv):
        by_name[e.name] += t - s
    out["device_ops"] = sorted(([n, v] for n, v in by_name.items()),
                               key=lambda kv: -kv[1])[:10]
    origin = min(s for s, _ in iv)
    spans = [(s - t0, e - t0, name) for name, lst in rec.stamps.items()
             for s, e in lst if s >= t0]
    named = []
    for g0, g1 in idle_gaps(iv):
        mid = 0.5 * (g0 + g1) - origin
        # the innermost (latest-starting) span the host was in
        inside = max(((s, name) for s, e, name in spans if s <= mid <= e),
                     default=(0.0, "outside the harness's spans"))
        named.append([inside[1], g1 - g0])
    named.sort(key=lambda kv: -kv[1])
    out["idle_gaps"] = named[:10]
    return out


def spmv_floor_bytes(nnz: int, nrows: int, value_bytes: int) -> int:
    """The least bytes any SpMV y = A x must move: each stored value of
    A once, x once and y once, at the logical row count; no index bytes,
    no padding, no DIA lane slots."""
    return nnz * value_bytes + 2 * nrows * value_bytes


def roofline_share(floor_bytes: int, seconds: float,
                   peak_bytes_s: float = H100_PEAK_BYTES_S) -> float:
    """The least time over the measured time, in %."""
    return 100.0 * floor_bytes / peak_bytes_s / seconds
