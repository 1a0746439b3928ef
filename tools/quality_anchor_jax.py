#!/usr/bin/env python3
"""The JAX package's own runs, on the CPU, of the quality-controlled and
smoothed setups: the anchors that the PyTorch port is held to.

    MGS_NO_WARMSET=1 JAX_PLATFORMS=cpu python tools/quality_anchor_jax.py \
        [--only csky_check poisson_smooth smooth_level0 csky_notay refresh
                skipass] \
        [--csky-grid 80] [--poisson-grid 1000] [--smooth-grid 100] \
        [--smooth-full-grid 500] [--skipass-n 1000000] \
        [--out tools/quality_anchor_results.json]

Everything runs in float32 on the plan-free path, b = RandomState(0).rand(n)
as in ``tools/csky_anchor_jax.py``; the hierarchies take ``bench.py``'s
solve settings (Chebyshev degree 2, K-cycle depth 3, pre and post 1).

* ``csky_check``: csky3d(80) (union field) with ``check_tentagg=True``
  (ktg 10, npass 2, tou 8, coarsest ≤ 512): levels, a SHA-256 of each
  level's labels (int32, the first ``nrows`` entries), ``solve_refined``
  to 1e-8 (inner 1e-5) and one BiCGStab solve to 1e-6, and per checked
  pass and retry the tentative pairs and the rejected ones (read from
  checktentagg's outputs through ``jax.debug.callback`` in a second setup,
  whose labels must equal the first's);
* ``poisson_smooth``: poisson2d(100) with ``smooth_p = 2/3`` (the
  benchmark's symmetric aggregation): levels, each level's P_s and Pᵀ slot
  width, each coarse operator's K, a SHA-256 of each level's P_s, Pᵀ and
  coarse operator (columns, then values), and the K-cycle BiCGStab count
  to 1e-6 on the weighted transfers.  Smoothing widens every coarse level
  (P_sᵀ A P_s has slot widths 5, 22, 79, 330 at n = 10⁴), and the JAX
  package's merge SpGEMM then outgrows this machine: poisson2d(500) passed
  60 GB and poisson2d(200) 25 GB before either ended;
* ``smooth_level0``: the first aggregation round of poisson2d(500) with
  the benchmark's aggregation (``pairwise_aggregate``): the labels that
  a ``smooth_p`` setup of it takes on level 0 (smoothing changes only the
  levels below), which the card's full-size smoothed cell is held to;
* ``csky_notay``: csky3d(80) with ``mu_mode="notay"``: levels and the
  1e-6 count;
* ``refresh``: poisson2d(1000)'s benchmark setup refreshed for A₁ = 1.7·A +
  0.3·I on the same pattern (``refresh_setup``): each coarse operator's K
  and a SHA-256 of its values, and the 1e-6 count on A₁;
* ``skipass``: the periodic 1-D chain of ``tests/test_aggregation.py``
  (¾ of the diagonal 1000, the rest 2.05, −1 off the diagonal) at n rows,
  one ``pairwise_aggregate`` with ``skipass_frac = 0.7`` (ktg 10, npass 2,
  tou 1e9): each pass's coarse size.

Each group prints its lines as it goes; the results of the groups run are
merged into ``--out`` (written to a temporary file, then renamed).
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

GROUPS = ("csky_check", "poisson_smooth", "smooth_level0", "csky_notay",
          "refresh", "skipass")
HIER = dict(smoother_kind="chebyshev", cycle="kcycle", pre_smooth=1,
            post_smooth=1, degree=2, kcycle_depth=3)
CSKY_AGG = dict(ktg=10.0, npass=2, tou=8.0)
BENCH_AGG = dict(ktg=10.0, npass=2, tou=8.0, symmetric=True)
SKIPASS_AGG = dict(ktg=10.0, npass=2, tou=1e9, skipass_frac=0.7)


def labels_hash(labels, n: int) -> str:
    import numpy as np
    return hashlib.sha256(np.ascontiguousarray(
        np.asarray(labels)[:n], dtype=np.int32).tobytes()).hexdigest()


def values_hash(vals) -> str:
    import numpy as np
    return hashlib.sha256(np.ascontiguousarray(np.asarray(vals))
                          .tobytes()).hexdigest()


def ell_hash(e) -> str:
    """SHA-256 of an ELL's columns, then its values."""
    import numpy as np
    h = hashlib.sha256(np.ascontiguousarray(np.asarray(e.cols)).tobytes())
    h.update(np.ascontiguousarray(np.asarray(e.vals)).tobytes())
    return h.hexdigest()


def skipass_chain(n: int):
    """The periodic chain with ¾ of its rows hugely diagonally dominant."""
    import numpy as np
    import scipy.sparse as sp
    d = np.full(n, 2.05)
    d[: 3 * n // 4] = 1000.0
    a = sp.diags([d, -np.ones(n - 1), -np.ones(n - 1)], [0, -1, 1]).tolil()
    a[0, n - 1] = -1.0
    a[n - 1, 0] = -1.0
    return sp.csr_matrix(a)


def setup_of(ell, agg: dict, smooth_p=None):
    from multigridsolver_tpu.setup.aggregation import build_amg_setup
    from multigridsolver_tpu.utils.config import (AggregationConfig,
                                                  HierarchyConfig)
    return build_amg_setup(ell, HierarchyConfig(
        max_coarse_size=512, smooth_p=smooth_p,
        aggregation=AggregationConfig(**agg)))


def solve_count(setup, b, tol=1e-6, with_p=False):
    from multigridsolver_tpu.solve.api import solve_hierarchy
    from multigridsolver_tpu.solve.hierarchy import build_hierarchy
    kw = dict(p_ops=setup.p_ops, pt_ops=setup.pt_ops) if with_p else {}
    hier = build_hierarchy(setup.matrices[0], setup.level_labels,
                           setup.matrices[1:], **HIER, **kw)
    res = solve_hierarchy(hier, b, method="bicgstab", tol=tol, maxiter=200)
    return hier, dict(iterations=int(res.iterations),
                      relres=float(res.relres), status=int(res.status))


def run_csky_check(args) -> dict:
    import jax
    import jax.numpy as jnp
    import numpy as np
    from multigridsolver_tpu.cli.generators import csky3d
    from multigridsolver_tpu.setup import aggregation as jagg
    from multigridsolver_tpu.setup import tentagg
    from multigridsolver_tpu.solve.api import solve_refined
    a = csky3d(args.csky_grid)
    ell = a.to_ell(dtype=jnp.float32, with_transpose=True)
    agg = dict(CSKY_AGG, check_tentagg=True)
    t0 = time.perf_counter()
    setup = setup_of(ell, agg)
    t_setup = time.perf_counter() - t0
    levels = [m.nrows for m in setup.matrices]
    hashes = [labels_hash(l, m.nrows)
              for l, m in zip(setup.level_labels, setup.matrices)]
    print(f"csky_check levels {levels}", flush=True)
    b = np.random.RandomState(0).rand(a.nrows)
    hier, res6 = solve_count(setup, b)
    _, relres, inner, outer = solve_refined(hier, a, b, tol=1e-8,
                                            inner_tol=1e-5)
    print(f"csky_check refined {inner}/{outer} relres {relres!r}; 1e-6 "
          f"{res6}", flush=True)
    # the verdict log: a second setup whose checktentagg reports its
    # tentative and rejected pairs; its labels must equal the first's
    log = []
    orig = tentagg.checktentagg

    def logged(a0, si0, labels, ac, paired, ktg, zerors, km):
        acc = orig(a0, si0, labels, ac, paired, ktg, zerors, km)
        cn = jnp.arange(paired.shape[0], dtype=jnp.int32)
        lead = (paired >= 0) & (paired > cn)
        jax.debug.callback(lambda p, r: log.append([int(p), int(r)]),
                           jnp.sum(lead), jnp.sum(lead & ~acc),
                           ordered=True)
        return acc
    # the checked pass is traced anew (its compiled program is cached)
    jagg._match_pass_checked.clear_cache()
    tentagg.checktentagg = logged
    try:
        logged_setup = setup_of(ell, agg)
    finally:
        tentagg.checktentagg = orig
        jagg._match_pass_checked.clear_cache()
    same = all(labels_hash(l, m.nrows) == h for l, m, h in zip(
        logged_setup.level_labels, logged_setup.matrices, hashes))
    print(f"csky_check verdict log (pairs, rejected) per retry {log}; "
          f"labels of the logged run equal: {same}", flush=True)
    return dict(grid=args.csky_grid, levels=levels, labels_sha256=hashes,
                level_k=[m.k for m in setup.matrices],
                refined_inner=int(inner), refined_outer=int(outer),
                refined_relres=float(relres), solve_1e6=res6,
                checks=log if same else None, setup_seconds=t_setup)


def run_poisson_smooth(args) -> dict:
    import jax.numpy as jnp
    import numpy as np
    from multigridsolver_tpu.cli.generators import poisson2d
    a = poisson2d(args.smooth_grid)
    ell = a.to_ell(dtype=jnp.float32)
    t0 = time.perf_counter()
    setup = setup_of(ell, BENCH_AGG, smooth_p=2.0 / 3.0)
    t_setup = time.perf_counter() - t0
    levels = [m.nrows for m in setup.matrices]
    out = dict(grid=args.smooth_grid, omega=2.0 / 3.0, levels=levels,
               labels_sha256=[labels_hash(l, m.nrows) for l, m in zip(
                   setup.level_labels, setup.matrices)],
               p_k=[p.k for p in setup.p_ops],
               pt_k=[p.k for p in setup.pt_ops],
               level_k=[m.k for m in setup.matrices],
               p_sha256=[ell_hash(p) for p in setup.p_ops],
               pt_sha256=[ell_hash(p) for p in setup.pt_ops],
               ops_sha256=[ell_hash(m) for m in setup.matrices[1:]],
               setup_seconds=t_setup)
    print(f"poisson_smooth {out}", flush=True)
    b = np.random.RandomState(0).rand(a.nrows)
    _, out["solve_1e6"] = solve_count(setup, b, with_p=True)
    print(f"poisson_smooth 1e-6 {out['solve_1e6']}", flush=True)
    return out


def run_smooth_level0(args) -> dict:
    import jax.numpy as jnp
    from multigridsolver_tpu.cli.generators import poisson2d
    from multigridsolver_tpu.setup.aggregation import pairwise_aggregate
    from multigridsolver_tpu.utils.config import AggregationConfig
    ell = poisson2d(args.smooth_full_grid).to_ell(dtype=jnp.float32)
    res = pairwise_aggregate(ell, AggregationConfig(**BENCH_AGG))
    out = dict(grid=args.smooth_full_grid, nc=int(res.nc),
               labels_sha256=labels_hash(res.labels, ell.nrows))
    print(f"smooth_level0 {out}", flush=True)
    return out


def run_csky_notay(args) -> dict:
    import jax.numpy as jnp
    import numpy as np
    from multigridsolver_tpu.cli.generators import csky3d
    a = csky3d(args.csky_grid)
    ell = a.to_ell(dtype=jnp.float32, with_transpose=True)
    setup = setup_of(ell, dict(CSKY_AGG, mu_mode="notay"))
    levels = [m.nrows for m in setup.matrices]
    b = np.random.RandomState(0).rand(a.nrows)
    _, res6 = solve_count(setup, b)
    out = dict(grid=args.csky_grid, levels=levels,
               labels_sha256=[labels_hash(l, m.nrows) for l, m in zip(
                   setup.level_labels, setup.matrices)],
               solve_1e6=res6)
    print(f"csky_notay {out}", flush=True)
    return out


def run_refresh(args) -> dict:
    import dataclasses
    import jax.numpy as jnp
    import numpy as np
    from multigridsolver_tpu.cli.generators import poisson2d
    from multigridsolver_tpu.setup.aggregation import refresh_setup
    a = poisson2d(args.poisson_grid)
    ell = a.to_ell(dtype=jnp.float32)
    setup = setup_of(ell, BENCH_AGG)
    isdiag = (ell.cols == ell.row_iota()) & ell.slot_mask()
    vals1 = (jnp.float32(1.7) * ell.vals
             + jnp.where(isdiag, jnp.float32(0.3), jnp.float32(0.0)))
    ref = refresh_setup(setup, dataclasses.replace(ell, vals=vals1))
    b = np.random.RandomState(0).rand(a.nrows)
    _, res6 = solve_count(ref, b)
    out = dict(grid=args.poisson_grid, levels=[m.nrows for m in ref.matrices],
               level_k=[m.k for m in ref.matrices],
               vals_sha256=[values_hash(m.vals) for m in ref.matrices[1:]],
               fine_vals_sha256=values_hash(vals1), solve_1e6=res6)
    print(f"refresh {out}", flush=True)
    return out


def run_skipass(args) -> dict:
    import jax.numpy as jnp
    from multigridsolver_tpu.setup.aggregation import pairwise_aggregate
    from multigridsolver_tpu.sparse.formats import CSR
    from multigridsolver_tpu.utils.config import AggregationConfig
    ell = CSR.from_scipy(skipass_chain(args.skipass_n)).to_ell(
        dtype=jnp.float32)
    res = pairwise_aggregate(ell, AggregationConfig(**SKIPASS_AGG))
    out = dict(n=args.skipass_n, passes=[p.nc for p in res.passes],
               pass_nnz=[p.nnz for p in res.passes], nc=res.nc,
               labels_sha256=labels_hash(res.labels, args.skipass_n))
    print(f"skipass {out}", flush=True)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", nargs="+", choices=GROUPS, default=GROUPS)
    ap.add_argument("--csky-grid", type=int, default=80)
    ap.add_argument("--poisson-grid", type=int, default=1000)
    ap.add_argument("--smooth-grid", type=int, default=100)
    ap.add_argument("--smooth-full-grid", type=int, default=500)
    ap.add_argument("--skipass-n", type=int, default=1000000)
    ap.add_argument("--out", default=os.path.join(
        os.path.dirname(os.path.abspath(__file__)),
        "quality_anchor_results.json"))
    args = ap.parse_args()
    os.environ.setdefault("MGS_NO_WARMSET", "1")
    runners = dict(csky_check=run_csky_check,
                   poisson_smooth=run_poisson_smooth,
                   smooth_level0=run_smooth_level0,
                   csky_notay=run_csky_notay, refresh=run_refresh,
                   skipass=run_skipass)
    results = {}
    if os.path.exists(args.out):
        with open(args.out) as f:
            results = json.load(f)
    for g in args.only:
        t0 = time.perf_counter()
        results[g] = runners[g](args)
        results[g]["seconds"] = time.perf_counter() - t0
        tmp = args.out + ".tmp"
        with open(tmp, "w") as f:
            json.dump(results, f, indent=1, sort_keys=True)
            f.write("\n")
        os.replace(tmp, args.out)
    print(json.dumps({g: results[g] for g in args.only}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
