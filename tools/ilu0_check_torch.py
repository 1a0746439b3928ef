"""The ILU(0) cell's program on the card at full size, checked.

    python tools/ilu0_check_torch.py [--grid 2000] [--device cuda|cpu]
        [--out FILE]

On the cell ``poisson2000ilu0.solve`` of ``BENCHMARK.json`` (its
configuration at ``--grid``):

1. the finest level's Chow–Patel factors (``smoothers.ilu0_factor``,
   float32, the configuration's sweeps) against the plain reference's
   sweeps in float64 (``portbench/ilu_reference.py``, its triples listed
   in blocks of rows), entry by entry at rtol 1e-5;
2. the cell's set-up as the benchmark makes it (``systems.SolveSystem``:
   pack, setup, hierarchy, one warm-up solve), then one solve under the
   program's tracer: the ``kcycle.*`` counters (every call a replay),
   x bitwise that of an untraced solve, the K-cycle's replay bitwise the
   eager cycle on one right-hand side, and the graph's memory;
3. one more ``build_hierarchy`` under a tracer with ``device_spans``:
   the ``ilu0.factor`` device time per level and the ``smooth`` and
   ``ilu0.tri_spmv`` records of one eager cycle.

Prints one JSON object (also written to ``--out``) and exits 1 if a
check fails.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from multigridsolver_tpu_torch.utils import timing  # noqa: E402
from portbench import harness, ilu_reference, systems  # noqa: E402
from portbench.trace import Record, sync  # noqa: E402

CELL = "poisson2000ilu0.solve"
RTOL = 1e-5


def factor_check(system, device) -> dict:
    """The finest level's factors against the plain sweeps."""
    from multigridsolver_tpu_torch.solve.smoothers import ilu0_factor
    from multigridsolver_tpu_torch.sparse.formats import CSR
    sweeps = int(system.config["hierarchy"]["factor_sweeps"])
    ell = CSR.from_scipy(system.a).to_ell(dtype=system.dtype, device=device)
    sync(device)
    t0 = time.perf_counter()
    lv, uv, ud = ilu0_factor(ell, sweeps=sweeps)
    sync(device)
    port_s = time.perf_counter() - t0
    ip, ix, v = ilu_reference.csr_arrays(system.a, device=device)
    t0 = time.perf_counter()
    want = ilu_reference.chow_patel(ip, ix, v, sweeps, block=1 << 22)
    sync(device)
    plain_s = time.perf_counter() - t0
    n = ell.nrows
    mask = ell.slot_mask() & ell.row_mask()[None, :]
    rows = ell.row_iota()[mask].long()
    cols = ell.cols[mask].long()
    got = torch.where(cols < rows, lv[mask], uv[mask]).double()
    got = torch.where(cols == rows, ud.double()[rows], got)
    keys = ilu_reference.entry_rows(ip) * n + ix
    pos = torch.searchsorted(keys, rows * n + cols)
    same_pattern = bool(torch.equal(keys[pos], rows * n + cols)) \
        and pos.numel() == keys.numel()
    ref = want[pos]
    rel = (got - ref).abs() / ref.abs()
    out = dict(entries=int(pos.numel()), same_pattern=same_pattern,
               max_rel=float(rel.max()),
               over_rtol=int((rel > RTOL).sum()), port_s=port_s,
               plain_s=plain_s, sweeps=sweeps, rtol=RTOL)
    out["ok"] = same_pattern and out["over_rtol"] == 0
    del ell, lv, uv, ud, want, got, ref, rel
    return out


def memory(device) -> dict:
    if device.type != "cuda":
        return {}
    return dict(memory_allocated=torch.cuda.memory_allocated(device),
                memory_peak=torch.cuda.max_memory_allocated(device))


def graph_check(system, device) -> dict:
    """Counters, bitwise replays and the graph's memory on the cell's
    hierarchy (after the set-up's warm-up solve)."""
    from multigridsolver_tpu_torch.solve.hierarchy import _cycle
    hier = system.hier
    b = system.stream.rhs(0)
    plain = system.solve(hier, b)
    tracer = timing.PhaseTimer(device=device)
    with timing.tracing(tracer):
        traced = system.solve(hier, b)
    sync(device)
    calls = tracer.counts.get("precondition", 0)
    r = torch.rand(hier.levels[0].a.npad, dtype=system.dtype, device=device)
    replay = hier.precondition(r)
    eager = _cycle(hier, 0, r)
    pool = hier._graph.graph.pool() if hier._graph else None
    out = dict(iterations=traced.iterations, status=traced.status,
               counters=dict(tracer.counters), precondition_calls=calls,
               x_bitwise=bool(torch.equal(plain.x, traced.x)),
               replay_bitwise=bool(torch.equal(replay, eager)),
               graph_pool=str(pool),
               **memory(device))
    # on the card every call replays; elsewhere every call is eager
    kind = "kcycle.replay" if device.type == "cuda" else "kcycle.eager"
    out["ok"] = (out["x_bitwise"] and out["replay_bitwise"]
                 and tracer.counters.get(kind, 0) == calls > 0
                 and traced.status == 0)
    return out


def span_check(system, device) -> dict:
    """``ilu0.factor`` device time per level of one more build, and one
    eager cycle's ``smooth`` spans and triangular SpMVs."""
    from multigridsolver_tpu_torch.setup.aggregation import build_amg_setup
    from multigridsolver_tpu_torch.solve.hierarchy import (_cycle,
                                                           build_hierarchy)
    from multigridsolver_tpu_torch.sparse.formats import CSR
    cfg = system.config
    ell = CSR.from_scipy(system.a).to_ell(dtype=system.dtype, device=device)
    setup = build_amg_setup(ell, systems.hierarchy_config(cfg))
    sync(device)
    tracer = timing.PhaseTimer(device=device, device_spans=("ilu0.factor",))
    t0 = time.perf_counter()
    with timing.tracing(tracer):
        hier = build_hierarchy(setup.matrices[0], setup.level_labels,
                               setup.matrices[1:], **cfg["hierarchy"])
        sync(device)
        build_s = time.perf_counter() - t0
        r = torch.rand(hier.levels[0].a.npad, dtype=system.dtype,
                       device=device)
        _cycle(hier, 0, r)
    sync(device)
    factor = tracer.device_seconds("ilu0.factor")
    host = {k[1]: t for k, t in tracer.times.items()
            if isinstance(k, tuple) and k[0] == "ilu0.factor"}
    smooth = {k[1]: c for k, c in tracer.counts.items()
              if isinstance(k, tuple) and k[0] == "smooth"}
    out = dict(build_hierarchy_s=build_s,
               factor_device_ms={str(k): 1e3 * v for k, v in factor.items()},
               factor_host_ms={str(k): 1e3 * v for k, v in host.items()},
               factor_device_ms_total=1e3 * sum(factor.values()),
               smooth_spans=smooth,
               tri_spmv=tracer.counters.get("ilu0.tri_spmv", 0),
               levels=[lv.a.nrows for lv in hier.levels])
    out["ok"] = (len(host) == len(hier.levels) and out["tri_spmv"] > 0
                 and (device.type != "cuda" or len(factor) == len(host)))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--grid", type=int, default=2000)
    ap.add_argument("--seed", type=int, default=2 ** 31 + 11)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    device = torch.device(args.device, 0) if args.device == "cuda" \
        else torch.device("cpu")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    cell = harness.resolve(ROOT, CELL)
    cell.config["generator"]["grid"] = args.grid
    system = systems.make(cell.config, cell.traffic, device,
                          Record(device, False), args.seed)
    out = dict(card=harness.power_limit(), grid=args.grid)
    out["factors"] = factor_check(system, device)
    if device.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    system.setup()
    sync(device)
    out["setup_s"] = time.perf_counter() - t0
    out["levels"] = system.levels
    out["graph"] = graph_check(system, device)
    out["spans"] = span_check(system, device)
    out["ok"] = all(out[k]["ok"] for k in ("factors", "graph", "spans"))
    line = json.dumps(out)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line)
    return 0 if out["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
