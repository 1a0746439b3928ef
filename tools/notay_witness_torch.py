#!/usr/bin/env python3
"""The PyTorch port's own run, on the CPU, of csky3d(80) with Notay's μ:
a second witness beside the JAX package's CPU anchor for the K-cycle
BiCGStab count to 1e-6.

    python tools/notay_witness_torch.py [--grid 80] \
        [--out tools/notay_witness_results.json]

The setup runs in float32 (ktg 10, npass 2, tou 8, coarsest ≤ 512,
``mu_mode="notay"``), b = RandomState(0).rand(n) as in
``tools/quality_anchor_jax.py``, the hierarchy takes the benchmark's
solve settings (Chebyshev degree 2, K-cycle depth 3, pre and post 1).
It records the levels, a SHA-256 of each level's labels, and the solve
count and relres in float32 and in float64 on the same hierarchy (its
float32 operators cast exactly), each beside the relres one iteration
before it.  The result is written to a temporary file, then renamed.
"""
from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def count(hier, b) -> dict:
    from multigridsolver_tpu_torch.solve.api import solve_hierarchy
    res = solve_hierarchy(hier, b, method="bicgstab", tol=1e-6, maxiter=200)
    before = solve_hierarchy(hier, b, method="bicgstab", tol=1e-6,
                             maxiter=max(res.iterations - 1, 1))
    return dict(iterations=int(res.iterations), relres=float(res.relres),
                status=int(res.status),
                relres_one_before=float(before.relres))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--grid", type=int, default=80)
    ap.add_argument("--out", default=os.path.join(
        os.path.dirname(os.path.abspath(__file__)),
        "notay_witness_results.json"))
    args = ap.parse_args()
    import numpy as np
    import torch
    from multigridsolver_tpu_torch.cli.generators import csky3d
    from multigridsolver_tpu_torch.setup.aggregation import build_amg_setup
    from multigridsolver_tpu_torch.solve.hierarchy import build_hierarchy
    from multigridsolver_tpu_torch.utils.config import (
        BENCH_HIERARCHY, CSKY_AGGREGATION, AggregationConfig,
        HierarchyConfig)
    t0 = time.perf_counter()
    a = csky3d(args.grid)
    b = np.random.RandomState(0).rand(a.nrows)
    cfg = HierarchyConfig(max_coarse_size=512, aggregation=AggregationConfig(
        **CSKY_AGGREGATION, mu_mode="notay"))
    ell = a.to_ell(dtype=torch.float32, device="cpu", with_transpose=True)
    setup = build_amg_setup(ell, cfg)
    out = dict(grid=args.grid, levels=[m.nrows for m in setup.matrices],
               labels_sha256=[hashlib.sha256(np.ascontiguousarray(
                   l.to(torch.int32).numpy()[:m.nrows]).tobytes())
                   .hexdigest() for l, m in zip(setup.level_labels,
                                                setup.matrices)])
    print(f"levels {out['levels']}", flush=True)
    hier = build_hierarchy(setup.matrices[0], setup.level_labels,
                           setup.matrices[1:], **BENCH_HIERARCHY)
    out["float32"] = count(hier, b)
    print(f"float32 {out['float32']}", flush=True)
    m64 = [dataclasses.replace(m, vals=m.vals.double(), vals_t=None)
           for m in setup.matrices]
    hier64 = build_hierarchy(m64[0], setup.level_labels, m64[1:],
                             **BENCH_HIERARCHY)
    out["float64"] = count(hier64, b)
    print(f"float64 {out['float64']}", flush=True)
    out["seconds"] = time.perf_counter() - t0
    tmp = args.out + ".tmp"
    with open(tmp, "w") as f:
        json.dump(out, f, indent=1, sort_keys=True)
        f.write("\n")
    os.replace(tmp, args.out)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
