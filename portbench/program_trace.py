"""The program's own spans and counters over a request, for the readers
of ``issue_ms``, ``read_wait_ms``, ``tail_share``, ``host_reads``,
``refine_host_ms`` and ``host_compute_idle``.

After the window, :func:`probe` starts a fresh process (this module run
with ``-m``) that sets the cell's system up as the run did (the same
configuration, traffic and seed) and runs a request of its kind with
the program's tracer installed (``utils/timing.tracing``):

* ``solve``: one ``solve_one`` (nothing kept);
* ``build``: one ``build`` of the first scaled copy;
* ``solution``: one ``solution_one`` (nothing kept), then one more under
  ``torch.profiler``, device activity only, for ``host_compute_idle``:
  the tracer's marker (its first event in the device trace) places its
  spans on the device's clock.

A fresh process, because the run's own has been profiled by then: after
a ``torch.profiler`` session the host issues a K-cycle more slowly, by
60 % on the H100's host (PERF.md §6), and not by the same amount
every time.  The process prints the six values; :func:`probe` keeps them
on the run, so the readers of one cell share one process.  Off the card,
or with a program whose ``utils/timing`` has no tracer to install, there
are none and every reader returns None.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import torch

from .trace import H100_PEAK_BYTES_S, Record, device_events, idle_gaps, \
    spmv_floor_bytes, sync

# a level is launch-bound when its SpMV's least time is under this: the
# empty kernel's device time on the H100 (0.0046-0.0049 ms)
LAUNCH_FLOOR_S = 5e-6
ROOT = Path(__file__).resolve().parents[1]
PROBE_TIMEOUT_S = 600


def probe(run) -> dict | None:
    """The six values of one request traced in a fresh process (None off
    the card or where the program has no tracer), cached on ``run``."""
    if not hasattr(run, "program_trace"):
        run.program_trace = None
        if run.device.type == "cuda" and has_tracer():
            run.program_trace = in_fresh_process(run.system, run.device)
    return run.program_trace


def has_tracer() -> bool:
    from multigridsolver_tpu_torch.utils import timing
    return hasattr(timing, "tracing")


def in_fresh_process(system, device: torch.device) -> dict | None:
    """:func:`measure` in a new process on ``system``'s configuration,
    traffic and seed: its values, or None (its errors on this process's
    standard error) if it failed."""
    job = dict(config=system.config, traffic=system.traffic,
               seed=system.stream.seed, device=str(device))
    try:
        proc = subprocess.run(
            [sys.executable, "-m", "portbench.program_trace"],
            input=json.dumps(job), capture_output=True, text=True, cwd=ROOT,
            timeout=PROBE_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        print(f"portbench: the program's trace outlived {PROBE_TIMEOUT_S} s",
              file=sys.stderr)
        return None
    lines = proc.stdout.strip().splitlines()
    if proc.returncode != 0 or not lines:
        print(f"portbench: the program's trace failed (rc "
              f"{proc.returncode}): {proc.stderr[-3000:]}", file=sys.stderr)
        return None
    return json.loads(lines[-1])


def trace_request(system, device: torch.device, i: int,
                  profiled: bool = False):
    """One request of ``system``'s kind with the program's tracer
    installed: a dict of the tracer; ``profiled`` (on the card) under
    ``torch.profiler``, device activity only, with the device's
    intervals and, where the trace kept the marker, the shift from the
    host's clock to the device's and the host's stamp at the request's
    end.  None where the program has no tracer, or for ``profiled`` off
    the card."""
    from multigridsolver_tpu_torch.utils import timing
    if not hasattr(timing, "tracing") or (profiled
                                          and device.type != "cuda"):
        return None
    from .systems import BuildSystem, SolveSystem
    tracer = timing.PhaseTimer(device=device)
    out = dict(tracer=tracer)

    def request():
        if isinstance(system, SolveSystem):
            system.solve_one(i, keep=False)
        elif isinstance(system, BuildSystem):
            system.build(system.copies[0])
        else:
            system.solution_one(i, keep=False)
        sync(device)

    sync(device)
    with system.rec.stamping():
        if not profiled:
            with timing.tracing(tracer):
                request()
            return out
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            sync(device)
            with timing.tracing(tracer):
                request()
                end = time.perf_counter()
    events = device_events(prof)
    out["intervals"] = [(e.time_range.start * 1e-6, e.time_range.end * 1e-6)
                        for e in events]
    # the device was idle when the tracer launched its marker, so the
    # marker is the trace's first event
    if events and timing.MARKER_KERNEL in events[0].name:
        # device time = host time + shift
        out["shift"] = out["intervals"][0][0] - tracer.marker
        out["end"] = end
    return out


def measure(system, device: torch.device, i: int) -> dict | None:
    """The six values, each where the request's kind has it: all but
    ``host_compute_idle`` from one request (:func:`trace_request`), and
    for ``solution`` on the card ``host_compute_idle`` from one more
    under the profiler (which slows the host's share of the request)."""
    from .systems import SolutionSystem
    got = trace_request(system, device, i)
    if got is None:
        return None
    tracer = got["tracer"]
    out = {}
    pre = tracer.spans("precondition")
    if pre:
        out["issue_ms"] = 1e3 * sum(t1 - t0 for _, t0, t1 in pre) / len(pre)
        out["tail_share"] = tail_share(tracer,
                                       launch_bound_levels(system.hier))
    reads = tracer.spans("krylov.read")
    if reads:
        out["read_wait_ms"] = 1e3 * sum(t1 - t0 for _, t0, t1 in reads)
    out["host_reads"] = float(tracer.counters.get("host_reads", 0))
    if tracer.spans("refine.residual"):
        out["refine_host_ms"] = 1e3 * span_seconds(tracer, "refine.")
    got = (trace_request(system, device, i + 1, profiled=True)
           if isinstance(system, SolutionSystem) else None)
    if got is not None and "shift" in got:
        shift, tracer = got["shift"], got["tracer"]
        spans = [(t0 + shift, t1 + shift)
                 for name, _, t0, t1 in tracer.records
                 if name.startswith(("pack.", "refine."))]
        if spans:
            out["host_compute_idle"] = host_idle_share(
                got["intervals"], spans, tracer.marker + shift,
                got["end"] + shift)
    return {k: v for k, v in out.items() if v is not None}


def span_seconds(tracer, prefix: str) -> float:
    """Total time of the tracer's spans whose name starts with
    ``prefix``."""
    return sum(t1 - t0 for name, _, t0, t1 in tracer.records
               if name.startswith(prefix))


def launch_bound_levels(hier, peak_bytes_s: float = H100_PEAK_BYTES_S,
                        floor_s: float = LAUNCH_FLOOR_S) -> set[int]:
    """The levels whose SpMV's least time (``trace.spmv_floor_bytes`` of
    the level's stored values and rows over the peak) is under
    ``floor_s``.  A level's stored values: the nonzeros of its diagonal
    lanes and the stored slots of its ELL remainder."""
    out = set()
    for l, level in enumerate(hier.levels):
        a = level.a
        nnz = int((a.dvals != 0).sum())
        if a.ell is not None:
            nnz += int(a.ell.rownnz.sum())
        floor = spmv_floor_bytes(nnz, a.nrows, a.dvals.element_size())
        if floor / peak_bytes_s < floor_s:
            out.add(l)
    return out


def tail_share(tracer, launch_bound: set[int]) -> float | None:
    """The share of the ``precondition`` spans' time that is self time of
    the ``launch_bound`` levels and of the coarse solve, in %."""
    total = span_seconds(tracer, "precondition")
    if total <= 0:
        return None
    own = tracer.self_times(("level", "coarse_solve"))
    tail = own.get("coarse_solve", 0.0) + sum(
        own.get(("level", l), 0.0) for l in launch_bound)
    return 100.0 * tail / total


def union(intervals) -> list[tuple[float, float]]:
    """The union of ``(start, end)`` intervals as disjoint segments."""
    out: list[list[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def overlap(a, b) -> float:
    """Length of the intersection of two unions of disjoint segments."""
    total, j = 0.0, 0
    for s, e in a:
        while j < len(b) and b[j][1] <= s:
            j += 1
        k = j
        while k < len(b) and b[k][0] < e:
            total += max(0.0, min(e, b[k][1]) - max(s, b[k][0]))
            k += 1
    return total


def host_idle_share(intervals, spans, start: float,
                    end: float) -> float | None:
    """Of the device's idle time in [start, end] (the gaps between the
    device's operations, and before the first and after the last), the
    share that falls inside ``spans``, in %; every time on the device's
    clock."""
    busy = [(max(s, start), min(e, end)) for s, e in intervals
            if e > start and s < end]
    edges = [(start, start), (end, end)]
    gaps = idle_gaps(busy + edges)
    idle = sum(g1 - g0 for g0, g1 in gaps)
    if idle <= 0:
        return None
    return 100.0 * overlap(union(gaps), union(spans)) / idle


def main() -> int:
    """The fresh process of :func:`in_fresh_process`: the job on standard
    input, the values as the last line of standard output."""
    from . import systems
    job = json.loads(sys.stdin.read())
    device = torch.device(job["device"])
    if device.type == "cuda":
        torch.cuda.set_device(device)
    system = systems.make(job["config"], job["traffic"], device,
                          Record(device, False), job["seed"])
    system.setup()
    print(json.dumps(measure(system, device, 1)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
