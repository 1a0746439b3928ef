#!/usr/bin/env python3
"""The JAX package's own runs of the smoother, Krylov and two-level
configurations on the CPU: the anchors that the PyTorch port's
``smoothers`` phase of ``chip_smoke.py`` is held to.

    MGS_NO_WARMSET=1 JAX_PLATFORMS=cpu python tools/smoother_anchor_jax.py \
        [--only poisson,csky_gs2,csky_ilu0,two_level,two_level_250] \
        [--runs NAME,...] [--x64] [--out anchor.json]

Groups (each prints one line per configuration as it finishes, then one
JSON object with every result as the last line):

* ``poisson``: poisson2d(1000) f32 (n = 10⁶) through ``to_ell`` →
  ``build_amg_setup`` (ktg 10, npass 2, tou 8, symmetric, coarsest level at
  most 512 rows) → ``build_hierarchy`` (K-cycle, pre 1, post 1, depth 3)
  → ``solve_hierarchy`` to 1e-6 with ``b = RandomState(0).rand(n)``, for
  gs2, ilu0, jacobi and l1jacobi with BiCGStab, Chebyshev(2) with FCG and
  with GMRES (also to 1e-5, and on a V-cycle), gs2 and Chebyshev(2) with the additive
  combination (on the K-cycle and on a V-cycle), and gs2 through
  ``solve()`` (``SolveConfig`` with the same settings);
* ``csky_gs2`` / ``csky_ilu0``: csky3d(80) f32 packed with its
  transposed-value field, the nonsymmetric default setup, the same
  K-cycle on gs2 / ilu0, ``solve_refined`` to 1e-8 (inner 1e-5) and one
  ``solve_hierarchy`` to 1e-6;
* ``two_level``: poisson2d(100) f32 (the CLI's ``poisson10000``), P from
  the CLI ``setup`` command's aggregation (one ``pairwise_aggregate``
  round, ktg 10, npass 2, tou 8, the transposed-value field), then
  ``two_level_from_p`` with gs2 multiplicative, gs2 additive and ilu0,
  each with BiCGStab to 1e-6; ``two_level_250`` the same on
  poisson2d(250) (about 18,000 aggregates: a dense coarse LU of 1.3 GB
  in f32).

Every configuration uses the smoother defaults (2 sweeps, 2 inner sweeps,
ω 0.8, 5 factor sweeps for ilu0).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

GROUPS = ("poisson", "csky_gs2", "csky_ilu0", "two_level", "two_level_250")
KCYCLE = dict(cycle="kcycle", pre_smooth=1, post_smooth=1, kcycle_depth=3)
# name: (hierarchy settings, Krylov method[, tolerance (1e-6)[, the
# hierarchy's dtype (float32)]]); solve() is run separately
POISSON_RUNS = {
    "gs2": (dict(smoother_kind="gs2"), "bicgstab"),
    "ilu0": (dict(smoother_kind="ilu0"), "bicgstab"),
    "jacobi": (dict(smoother_kind="jacobi"), "bicgstab"),
    "l1jacobi": (dict(smoother_kind="l1jacobi"), "bicgstab"),
    "cheb2_fcg": (dict(smoother_kind="chebyshev", degree=2), "fcg"),
    "cheb2_gmres": (dict(smoother_kind="chebyshev", degree=2), "gmres"),
    "cheb2_gmres_1e5": (dict(smoother_kind="chebyshev", degree=2), "gmres",
                        1e-5),
    # the same K-cycle in float64 on the float32 setup's operators (cast):
    # XLA:CPU's float32 dot products over 10⁶ terms are off by about 1e-4
    # relative, which stalls GMRES's Gram-Schmidt in float32 (needs --x64)
    "cheb2_gmres_f64": (dict(smoother_kind="chebyshev", degree=2), "gmres",
                        1e-6, "float64"),
    # GMRES assumes a fixed preconditioner, which a V-cycle is and a
    # K-cycle (its inner FCG steps depend on the vector) is not
    "cheb2_vcycle_gmres": (dict(smoother_kind="chebyshev", degree=2,
                                cycle="vcycle"), "gmres"),
    "gs2_additive": (dict(smoother_kind="gs2", combination="additive"),
                     "bicgstab"),
    "cheb2_additive": (dict(smoother_kind="chebyshev", degree=2,
                            combination="additive"), "bicgstab"),
    # the additive combination on a V-cycle: each level's correction and
    # smoothing summed once, no inner Krylov steps
    "gs2_additive_vcycle": (dict(smoother_kind="gs2", combination="additive",
                                 cycle="vcycle"), "bicgstab"),
    "cheb2_additive_vcycle": (dict(smoother_kind="chebyshev", degree=2,
                                   combination="additive", cycle="vcycle"),
                              "bicgstab"),
}
TWO_LEVEL_RUNS = {
    "gs2": dict(smoother_kind="gs2"),
    "gs2_additive": dict(smoother_kind="gs2", combination="additive"),
    "ilu0": dict(smoother_kind="ilu0"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def timed(fn):
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


def solve_row(res, seconds) -> dict:
    return dict(iterations=int(res.iterations), relres=float(res.relres),
                status=int(res.status), seconds=seconds)


def run_poisson(out: dict, runs) -> None:
    import jax.numpy as jnp
    import numpy as np
    from multigridsolver_tpu.cli.generators import poisson2d
    from multigridsolver_tpu.setup.aggregation import build_amg_setup
    from multigridsolver_tpu.solve.api import solve, solve_hierarchy
    from multigridsolver_tpu.solve.hierarchy import build_hierarchy
    from multigridsolver_tpu.utils.config import (AggregationConfig,
                                                  HierarchyConfig,
                                                  SmootherConfig,
                                                  SolveConfig)
    a = poisson2d(1000)
    b = np.random.RandomState(0).rand(a.nrows)
    hcfg = HierarchyConfig(max_coarse_size=512, aggregation=AggregationConfig(
        ktg=10.0, npass=2, tou=8.0, symmetric=True))
    setup, t = timed(lambda: build_amg_setup(a.to_ell(dtype=jnp.float32),
                                             hcfg))
    levels = [m.nrows for m in setup.matrices]
    log(f"poisson1000 levels {levels} setup {t:.1f} s")
    group = out.setdefault("poisson", {"levels": levels})
    for name, (kw, method, *more) in POISSON_RUNS.items():
        if runs is not None and name not in runs:
            continue
        tol, dtype = (more + [1e-6, "float32"][len(more):])[:2]
        mats = [m.astype(jnp.dtype(dtype)) for m in setup.matrices]
        hier, t_h = timed(lambda: build_hierarchy(
            mats[0], setup.level_labels, mats[1:], **dict(KCYCLE, **kw)))
        res, t_s = timed(lambda: solve_hierarchy(
            hier, b, method=method, tol=tol, maxiter=200))
        row = solve_row(res, dict(hierarchy=t_h, solve=t_s))
        group[name] = row
        log(f"poisson1000 {name}: {json.dumps(row)}")
    if runs is not None and "gs2_solve" not in runs:
        return
    cfg = SolveConfig(method="bicgstab", tol=1e-6, max_iter=200,
                      cycle="kcycle", smoother=SmootherConfig(kind="gs2"),
                      dtype="float32", hierarchy=hcfg)
    (_, info), t = timed(lambda: solve(a, b, cfg))
    row = dict(iterations=info["iterations"], relres=info["relres"],
               status=info["status"], seconds=t,
               levels=[lv.a.nrows for lv in info["hierarchy"].levels])
    group["gs2_solve"] = row
    log(f"poisson1000 gs2_solve: {json.dumps(row)}")


def run_csky(out: dict, kind: str) -> None:
    import jax.numpy as jnp
    import numpy as np
    from multigridsolver_tpu.cli.generators import csky3d
    from multigridsolver_tpu.setup.aggregation import build_amg_setup
    from multigridsolver_tpu.solve.api import solve_hierarchy, solve_refined
    from multigridsolver_tpu.solve.hierarchy import build_hierarchy
    from multigridsolver_tpu.utils.config import (AggregationConfig,
                                                  HierarchyConfig)
    if "csky_setup" not in out:
        a = csky3d(80)
        setup, t = timed(lambda: build_amg_setup(
            a.to_ell(dtype=jnp.float32, with_transpose=True),
            HierarchyConfig(max_coarse_size=512,
                            aggregation=AggregationConfig(
                                ktg=10.0, npass=2, tou=8.0))))
        out["csky_setup"] = (a, setup)
        log(f"csky3d80 levels {[m.nrows for m in setup.matrices]} setup "
            f"{t:.1f} s")
    a, setup = out["csky_setup"]
    b = np.random.RandomState(0).rand(a.nrows)
    hier, t_h = timed(lambda: build_hierarchy(
        setup.matrices[0], setup.level_labels, setup.matrices[1:],
        smoother_kind=kind, **KCYCLE))
    (_, relres, inner, outer), t_r = timed(lambda: solve_refined(
        hier, a, b, tol=1e-8, inner_tol=1e-5))
    res, t_s = timed(lambda: solve_hierarchy(hier, b, method="bicgstab",
                                             tol=1e-6, maxiter=200))
    row = dict(levels=[m.nrows for m in setup.matrices],
               refined_relres=float(relres), inner=int(inner),
               outer=int(outer), **solve_row(res, dict(
                   hierarchy=t_h, solve_refined=t_r, solve=t_s)))
    out[f"csky_{kind}"] = row
    log(f"csky3d80 {kind}: {json.dumps(row)}")


def run_two_level(out: dict, grid: int) -> None:
    import jax.numpy as jnp
    import numpy as np
    from multigridsolver_tpu.cli.generators import poisson2d
    from multigridsolver_tpu.setup.aggregation import pairwise_aggregate
    from multigridsolver_tpu.setup.prolongation import p_csr_from_labels
    from multigridsolver_tpu.solve.api import (solve_hierarchy,
                                               two_level_from_p)
    from multigridsolver_tpu.utils.config import AggregationConfig
    a = poisson2d(grid)
    b = np.random.RandomState(0).rand(a.nrows)
    agg = pairwise_aggregate(a.to_ell(dtype=jnp.float32, with_transpose=True),
                             AggregationConfig(ktg=10.0, npass=2, tou=8.0))
    p = p_csr_from_labels(np.asarray(agg.labels)[: a.nrows], agg.nc)
    name = "two_level" if grid == 100 else f"two_level_{grid}"
    group = out.setdefault(name, {"n": a.nrows, "nc": int(agg.nc)})
    log(f"poisson{a.nrows} two-level: nc {agg.nc}")
    for run, kw in TWO_LEVEL_RUNS.items():
        hier, t_h = timed(lambda: two_level_from_p(a, p, dtype=jnp.float32,
                                                   **kw))
        res, t_s = timed(lambda: solve_hierarchy(hier, b, method="bicgstab",
                                                 tol=1e-6, maxiter=200))
        row = solve_row(res, dict(hierarchy=t_h, solve=t_s))
        group[run] = row
        log(f"poisson{a.nrows} two-level {run}: {json.dumps(row)}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", default=",".join(GROUPS),
                    help="comma-separated groups of " + ", ".join(GROUPS))
    ap.add_argument("--runs", default=None,
                    help="comma-separated poisson configurations (default: "
                         "all, and gs2_solve)")
    ap.add_argument("--x64", action="store_true",
                    help="enable float64 (for the float64 configurations)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    os.environ.setdefault("MGS_NO_WARMSET", "1")
    if args.x64:
        import jax
        jax.config.update("jax_enable_x64", True)
    groups = args.only.split(",")
    for g in groups:
        if g not in GROUPS:
            ap.error(f"unknown group {g!r}")
    out: dict = {}
    for g in GROUPS:
        if g not in groups:
            continue
        if g == "poisson":
            run_poisson(out, None if args.runs is None
                        else args.runs.split(","))
        elif g.startswith("csky_"):
            run_csky(out, g[len("csky_"):])
        else:
            run_two_level(out, 100 if g == "two_level" else 250)
    out.pop("csky_setup", None)
    line = json.dumps(out)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
