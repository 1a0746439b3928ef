"""Device profile of the port's phases on the benchmark problem
(poisson2d(1000) f32 on ``cuda:0``), unsharded and on a 4-shard row mesh.

    python -m multigridsolver_tpu_torch.utils.phase_profile [--out FILE]

For each path (``unsharded``; ``sharded``: ``build_amg_setup_sharded`` and
``shard_hierarchy(..., shard_levels=2)`` on a ``RowMesh(4)``) it runs
one call each of the setup, the hierarchy build and one preconditioner
application (a K-cycle), each after a warm-up call, under
``torch.profiler`` with CPU and CUDA activities, and reports per phase:

* ``wall_s``: host wall clock of the profiled call, ending in a
  synchronize;
* ``device_busy_s``: the union of the device events' time intervals;
* ``device_kernels``: the number of device events (kernels and copies);
* ``top``: the five kernel names with the most device time (µs, count).

Unprofiled wall times of the same calls (median of three) are printed
beside them, since tracing slows the host.  The whole solve is not traced:
its 10⁵-10⁶ launches take minutes to record.  One JSON object goes to
``--out`` and to the last line of standard output.
"""
from __future__ import annotations

import argparse
import json
import statistics
import time
from collections import defaultdict

import numpy as np
import torch

from .config import BENCH_GRID, BENCH_HIERARCHY, BENCH_NDEV, bench_config


def _wall(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _busy_us(intervals) -> float:
    """Length of the union of ``(start, end)`` intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def profile_call(fn, repeats: int = 3, host_ops: bool = True) -> dict:
    """One warm-up call of ``fn``, ``repeats`` unprofiled calls, one
    profiled call; the device figures of the profiled call.  With
    ``repeats=0`` (a caller that has run ``fn`` already) only the profiled
    call, and no unprofiled wall.  ``host_ops=False`` traces the device
    activity alone, for calls of 10⁵ kernels and more, whose host
    operators take minutes to record."""
    from torch.profiler import ProfilerActivity, profile
    if repeats:
        fn()
    unprofiled = [_wall(fn)[1] for _ in range(repeats)]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]
                 if host_ops else [ProfilerActivity.CUDA]) as prof:
        _, wall = _wall(fn)
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name = defaultdict(lambda: [0.0, 0])
    for e in kernels:
        by_name[e.name][0] += e.time_range.elapsed_us()
        by_name[e.name][1] += 1
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:5]
    return dict(
        wall_s=wall, unprofiled_wall_s=statistics.median(unprofiled)
        if unprofiled else None,
        device_busy_s=_busy_us((e.time_range.start, e.time_range.end)
                               for e in kernels) * 1e-6,
        device_kernels=len(kernels),
        top=[dict(name=n[:90], us=us, count=c) for n, (us, c) in top])


def run(device: torch.device) -> dict:
    from ..cli.generators import poisson2d
    from ..parallel import (RowMesh, build_amg_setup_sharded,
                            shard_hierarchy)
    from ..setup.aggregation import build_amg_setup
    from ..solve.api import pad_vector
    from ..solve.hierarchy import build_hierarchy
    cfg = bench_config()
    ell = poisson2d(BENCH_GRID).to_ell(dtype=torch.float32, device=device)
    b = np.random.RandomState(0).rand(ell.nrows)
    mesh = RowMesh(BENCH_NDEV, device)
    paths = {
        "unsharded": (lambda: build_amg_setup(ell, cfg), lambda h: h),
        "sharded": (lambda: build_amg_setup_sharded(ell, cfg, mesh),
                    lambda h: shard_hierarchy(h, mesh, shard_levels=2)),
    }
    out = {}
    for path, (setup_fn, distribute) in paths.items():
        setup = setup_fn()

        def hierarchy():
            return distribute(build_hierarchy(
                setup.matrices[0], setup.level_labels, setup.matrices[1:],
                **BENCH_HIERARCHY))
        hier = hierarchy()
        bp = pad_vector(b, hier.levels[0].a.npad, torch.float32, device)
        out[path] = dict(
            levels=[m.nrows for m in setup.matrices],
            setup=profile_call(setup_fn),
            hierarchy=profile_call(hierarchy),
            precondition=profile_call(lambda: hier.precondition(bp)))
        for phase in ("setup", "hierarchy", "precondition"):
            p = out[path][phase]
            share = p["device_busy_s"] / p["wall_s"] if p["wall_s"] else 0.0
            print(f"{path} {phase}: wall {p['wall_s']!r} s profiled, "
                  f"{p['unprofiled_wall_s']!r} s unprofiled; device busy "
                  f"{p['device_busy_s']!r} s ({100 * share:.1f} %), "
                  f"{p['device_kernels']} device kernels", flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args(argv)
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    res = dict(grid=BENCH_GRID, ndev=BENCH_NDEV, device=str(device),
               device_name=torch.cuda.get_device_name(device),
               paths=run(device))
    line = json.dumps(res)
    if args.out:
        with open(args.out, "w", encoding="utf-8") as fh:
            fh.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
