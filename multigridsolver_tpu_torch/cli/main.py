"""Command-line entry points mirroring the reference's binaries.

    python -m multigridsolver_tpu_torch setup <matrix> [--ktg --npass --tou]
        read ``<dir>/<matrix>.mtx``, run one round of multi-pass pairwise
        aggregation, write ``<dir>/<matrix>promatrix_<tag>.mtx`` (tag
        ``torch`` unless ``--tag`` says otherwise).

    python -m multigridsolver_tpu_torch solve <matrix> [torch|tpu|cpu|gpu]
        read the matrix and the prolongation file of that tag, build the
        two-level preconditioner, solve against a random right-hand side,
        print iterations and tolerance.  With ``--multilevel`` the
        K-cycle hierarchy of a full setup is used instead.

    python -m multigridsolver_tpu_torch generate poisson|csky2d|csky3d <n>
        write a test matrix.

    python -m multigridsolver_tpu_torch gridplot <matrix> [tag]
        colour the aggregates of a 2D problem; write the colour matrix and
        a PNG (the PNG needs matplotlib).

The commands, flags, defaults, file names and log lines are the JAX
package's (``multigridsolver_tpu.cli``), but for the default promatrix
tag (``torch``, so a port run never overwrites a JAX run's file in the
same directory) and ``--torch-device``, the torch device the work runs
on: the card unless the caller asks for another (``--torch-device
cpu``).
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch


def _matrix_path(args, name):
    return os.path.join(args.dir, f"{name}.mtx")


def cmd_setup(args):
    from ..io import read_mtx, write_mtx
    from ..setup.aggregation import pairwise_aggregate
    from ..setup.prolongation import p_csr_from_labels
    from ..utils.config import AggregationConfig
    from ..utils.timing import PhaseTimer, print_info, tracing

    a = read_mtx(_matrix_path(args, args.matrix))
    print_info("matrix", f"{a.nrows}x{a.ncols}, nnz={a.nnz}")
    # carry the transposed-value field (aⱼᵢ read from row i's own slots;
    # a structurally symmetric input keeps its pattern)
    ell = a.to_ell(dtype=torch.float32 if args.f32 else torch.float64,
                   device=args.torch_device, with_transpose=True)
    cfg = AggregationConfig(ktg=args.ktg, npass=args.npass, tou=args.tou,
                            matching=args.matching,
                            check_tentagg=args.check_tentagg)
    timer = PhaseTimer(device=args.torch_device)
    with tracing(timer), timer.phase("setup.total"):
        res = pairwise_aggregate(ell, cfg)
    timer.report()
    for i, p in enumerate(res.passes):
        print_info(f"AGMG round {i+1} completed, matrix size", p.nc)
    if args.verbose:
        # the Fortran's setup statistics: the coarsening table and the
        # μ-quality histogram of the matched pairs
        from ..utils.stats import aggregate_quality_histogram
        n, nnz = a.nrows, a.nnz
        print_info("coarsening", f"{n} -> {res.nc} "
                   f"(ratio {n / max(res.nc, 1):.2f})")
        for i, p in enumerate(res.passes):
            print_info(f"  pass {i+1}", f"nc={p.nc} nnz={p.nnz} "
                       f"nnz-ratio={p.nnz / nnz:.3f}")
        hist, n_pairs, n_single, n_excl = \
            aggregate_quality_histogram(ell, res.labels)
        print_info("pairs / singletons / excluded",
                   f"{n_pairs} / {n_single} / {n_excl}")
        print_info("pair-quality histogram (bucket k: k-1 < mu <= k)",
                   " ".join(str(int(h)) for h in hist))
    p = p_csr_from_labels(res.labels[: a.nrows].cpu().numpy(), res.nc)
    out = _matrix_path(args, f"{args.matrix}promatrix_{args.tag}")
    write_mtx(out, p)
    print_info("wrote", out)
    return res


def cmd_solve(args):
    """Returns (hierarchy, solve result)."""
    from ..io import read_mtx
    from ..solve.api import solve_hierarchy, two_level_from_p
    from ..utils.timing import PhaseTimer, print_info, tracing

    a = read_mtx(_matrix_path(args, args.matrix))
    rng = np.random.RandomState(args.seed)
    b = rng.rand(a.nrows)
    dtype = torch.float32 if args.f32 else torch.float64
    device = args.torch_device
    timer = PhaseTimer(device=device)
    combo = "additive" if args.additive else "multiplicative"
    # the program's spans and host reads land in the same report
    with tracing(timer):
        if args.multilevel:
            from ..setup.aggregation import build_amg_setup
            from ..solve.hierarchy import build_hierarchy
            from ..utils.config import AggregationConfig, HierarchyConfig
            ell = a.to_ell(dtype=dtype, device=device)
            agg = AggregationConfig(ktg=args.ktg, npass=args.npass,
                                    tou=args.tou,
                                    check_tentagg=args.check_tentagg)
            cfg = HierarchyConfig(max_coarse_size=args.max_coarse,
                                  aggregation=agg, smooth_p=args.smooth_p)
            with timer.phase("setup"):
                setup = build_amg_setup(ell, cfg)
            print_info("levels", [m.nrows for m in setup.matrices])
            with timer.phase("hierarchy"):
                hier = build_hierarchy(setup.matrices[0], setup.level_labels,
                                       setup.matrices[1:],
                                       smoother_kind=args.smoother,
                                       cycle="kcycle", pre_smooth=1,
                                       post_smooth=1, combination=combo,
                                       p_ops=setup.p_ops, pt_ops=setup.pt_ops)
        else:
            p = read_mtx(_matrix_path(args,
                                      f"{args.matrix}promatrix_{args.device}"))
            with timer.phase("hierarchy"):
                hier = two_level_from_p(a, p, smoother_kind=args.smoother,
                                        dtype=dtype, device=device,
                                        combination=combo)
        with timer.phase("solve"):
            res = solve_hierarchy(hier, b, method=args.method, tol=args.tol,
                                  maxiter=args.maxiter)
    timer.report()
    if int(res.status) == 0:
        print_info("Tolerance", float(res.relres))
        print_info("Number of iterations BICG", int(res.iterations))
    else:
        print(f"solver problem, status {int(res.status)}", file=sys.stderr)
        sys.exit(2)
    return hier, res


def cmd_generate(args):
    from ..io import write_mtx
    from .generators import csky2d, csky3d, poisson2d
    gen = {"poisson": poisson2d, "csky2d": csky2d, "csky3d": csky3d}
    mat = gen[args.family](args.n)
    name = args.out or {
        "poisson": f"poisson{args.n * args.n}",
        "csky2d": f"CSky2d{args.n}",
        "csky3d": f"CSky3d{args.n}"}[args.family]
    out = _matrix_path(args, name)
    write_mtx(out, mat)
    print(f"wrote {out}  ({mat.nrows}x{mat.ncols}, nnz={mat.nnz})",
          file=sys.stderr)
    return out


def cmd_gridplot(args):
    from .gridplot import grid_plot
    return grid_plot(
        _matrix_path(args, args.matrix),
        _matrix_path(args, f"{args.matrix}promatrix_{args.device}"),
        out_png=os.path.join(args.dir,
                             f"{args.matrix}grid_{args.device}.png"),
        out_mtx=os.path.join(args.dir,
                             f"{args.matrix}grid_{args.device}.mtx"))


def build_parser():
    ap = argparse.ArgumentParser(prog="multigridsolver_tpu_torch")
    ap.add_argument("--dir", default="matrices",
                    help="matrix directory (reference uses ../../matrices)")
    ap.add_argument("--torch-device", default="cuda",
                    help="torch device the work runs on (default: cuda)")
    sub = ap.add_subparsers(dest="cmd", required=True)

    s = sub.add_parser("setup", help="aggregation setup; writes promatrix")
    s.add_argument("matrix")
    s.add_argument("--ktg", type=float, default=10.0)
    s.add_argument("--npass", type=int, default=2)
    s.add_argument("--tou", type=float, default=8.0)
    s.add_argument("--check-tentagg", action="store_true",
                   help="PSD re-check of tentative aggregate merges in the "
                        "original matrix (dag2l_checktentagg)")
    s.add_argument("--matching", default="mutual",
                   choices=["mutual", "greedy"])
    s.add_argument("--tag", default="torch")
    s.add_argument("--f32", action="store_true")
    s.add_argument("-v", "--verbose", action="store_true",
                   help="print coarsening table + pair-quality histogram "
                        "(the Fortran's setup statistics)")
    s.set_defaults(fn=cmd_setup)

    s = sub.add_parser("solve", help="preconditioned Krylov solve")
    s.add_argument("matrix")
    s.add_argument("device", nargs="?", default="torch",
                   help="promatrix source tag (torch|tpu|cpu|gpu)")
    s.add_argument("--method", default="bicgstab",
                   choices=["bicgstab", "cg", "fcg", "gmres"])
    s.add_argument("--additive", action="store_true",
                   help="additive coarse+smoother combination instead of "
                        "multiplicative")
    s.add_argument("--tol", type=float, default=1e-6)
    s.add_argument("--maxiter", type=int, default=10000)
    s.add_argument("--seed", type=int, default=0)
    s.add_argument("--smoother", default="gs2",
                   choices=["jacobi", "l1jacobi", "chebyshev", "gs2",
                            "ilu0"])
    s.add_argument("--multilevel", action="store_true")
    s.add_argument("--check-tentagg", action="store_true",
                   help="PSD re-check of tentative aggregate merges")
    s.add_argument("--smooth-p", type=float, default=None, metavar="OMEGA",
                   help="smoothed-aggregation prolongation with damping "
                        "OMEGA (e.g. 0.667); default: piecewise-constant")
    s.add_argument("--max-coarse", type=int, default=512)
    s.add_argument("--ktg", type=float, default=10.0)
    s.add_argument("--npass", type=int, default=2)
    s.add_argument("--tou", type=float, default=8.0)
    s.add_argument("--f32", action="store_true")
    s.set_defaults(fn=cmd_solve)

    s = sub.add_parser("generate", help="write a test matrix")
    s.add_argument("family", choices=["poisson", "csky2d", "csky3d"])
    s.add_argument("n", type=int)
    s.add_argument("--out")
    s.set_defaults(fn=cmd_generate)

    s = sub.add_parser("gridplot", help="aggregate visualisation")
    s.add_argument("matrix")
    s.add_argument("device", nargs="?", default="torch")
    s.set_defaults(fn=cmd_gridplot)
    return ap


def main(argv=None):
    """Run one command; returns what the command returns (``solve``: the
    hierarchy and the solve result; ``setup``: the aggregation result)."""
    args = build_parser().parse_args(argv)
    return args.fn(args)
