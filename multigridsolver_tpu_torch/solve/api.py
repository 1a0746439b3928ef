"""High-level solve API: ``solve_hierarchy`` runs a Krylov method with
the multigrid hierarchy as right preconditioner; ``solve_refined`` wraps
it in mixed-precision iterative refinement; ``two_level_from_p`` builds
the reference's two-level preconditioner from an explicit P, and
``solve`` runs the whole chain from a ``SolveConfig``."""
from __future__ import annotations

import numpy as np
import torch

from ..setup.galerkin import galerkin_ell
from ..setup.prolongation import labels_from_p_csr
from ..utils import timing
from . import krylov
from .hierarchy import Hierarchy, build_hierarchy

# method: (Krylov solver, whether the hierarchy preconditions it); "none"
# is BiCGStab without a preconditioner
_METHODS = {"bicgstab": (krylov.bicgstab, True), "cg": (krylov.cg, True),
            "fcg": (krylov.fcg, True), "gmres": (krylov.gmres, True),
            "none": (krylov.bicgstab, False)}


def two_level_from_p(a, p, smoother_kind: str = "gs2",
                     cycle: str = "twolevel", dtype: torch.dtype = torch.float32,
                     device: torch.device | str = "cuda",
                     **smoother_kw) -> Hierarchy:
    """The reference's two-level preconditioner from an explicit
    piecewise-constant P (host :class:`~..sparse.formats.CSR` ``a`` and
    ``p``): Ac = PᵀAP (:func:`~..setup.galerkin.galerkin_ell`), factored
    densely, and the smoother standing in for the reference's ILUT half,
    combined with pre 0 and post 1 (multiplicatively c + S(b − A c), or
    additively with ``combination="additive"``).  ``smoother_kw`` goes to
    :func:`~.hierarchy.build_hierarchy`; the hierarchy lands on
    ``device``, the card unless the caller asks for another."""
    labels_np, nc = labels_from_p_csr(p)
    a_ell = a.to_ell(dtype=dtype, device=device)
    labels = torch.full((a_ell.npad,), -1, dtype=torch.int32, device=device)
    labels[: len(labels_np)] = torch.from_numpy(labels_np).to(device)
    ac = galerkin_ell(a_ell, labels, nc)
    return build_hierarchy(a_ell, [labels], [ac], smoother_kind=smoother_kind,
                           cycle="vcycle" if cycle == "twolevel" else cycle,
                           pre_smooth=0, post_smooth=1, **smoother_kw)


def pad_vector(v, npad: int, dtype: torch.dtype,
               device: torch.device | str = "cuda") -> torch.Tensor:
    """Zero-pad a logical-size vector (numpy or torch) to ``npad`` on
    ``device`` (the card unless the caller asks for another device)."""
    v = torch.as_tensor(np.asarray(v) if not torch.is_tensor(v) else v)
    out = torch.zeros((npad,), dtype=dtype, device=device)
    out[: v.shape[0]] = v.to(device=device, dtype=dtype)
    return out


def solve_hierarchy(hier: Hierarchy, b, method: str = "bicgstab",
                    tol: float = 1e-6,
                    maxiter: int = 10000) -> krylov.SolveResult:
    """Solve A x = b with the hierarchy as right preconditioner.

    ``b`` is a logical-size vector (numpy or torch); it is zero-padded to
    the finest operator's padded size (a row-sharded operator's, when the
    hierarchy is sharded) on its device, and the solution is returned
    un-padded.  On a hierarchy sharded over ranks (every rank calls) ``b``
    is the whole vector on every rank, of which each keeps its own rows;
    the solution is this rank's padded rows
    (``parallel.multihost.host_read(x, mesh)[:n]`` reads it whole), and
    the dot products are all-reduced."""
    if method not in _METHODS:
        raise ValueError(f"unknown method {method!r}; one of "
                         f"{tuple(_METHODS)}")
    fn, preconditioned = _METHODS[method]
    a = hier.levels[0].a if hier.levels else hier.coarse.a
    mesh = hier.mesh
    if mesh is None:
        bp = pad_vector(b, a.npad, a.dtype, a.device)
    else:
        npad = a.npad * mesh.world
        lo, hi = mesh.local_rows(npad)
        bp = pad_vector(b, npad, a.dtype, a.device)[lo:hi].contiguous()
    res = fn(hier.matvec, bp, hier.precondition if preconditioned else None,
             tol=tol, maxiter=maxiter,
             allsum=None if mesh is None else mesh.allreduce_sum)
    return res._replace(x=res.x if mesh is not None else res.x[: a.nrows])


def solve_refined(hier: Hierarchy, a_host, b, tol: float = 1e-8,
                  inner_tol: float = 1e-5, method: str = "bicgstab",
                  max_outer: int = 8, maxiter: int = 500):
    """Iterative refinement to tolerances beyond one f32 solve: each
    residual is taken in f64 on the host against the exact operator
    ``a_host`` (a host :class:`~..sparse.formats.CSR`), each correction
    A·dx = r is one :func:`solve_hierarchy` on the hierarchy's device to
    ``inner_tol``, and x is accumulated in f64 on the host.  A hierarchy
    sharded over ranks is refused.  Spans (``utils/timing``):
    ``refine.residual`` the host residual, ``refine.update`` x's copy
    back and its accumulation.

    Returns (x, relres, total_inner_iterations, outer_sweeps)."""
    if hier.mesh is not None:
        raise NotImplementedError("solve_refined takes a hierarchy in one "
                                  "process, not one sharded over ranks")
    with timing.span("refine.residual"):
        a_sp = a_host.to_scipy()
        b = np.asarray(b, dtype=np.float64)
        normb = np.linalg.norm(b)
        x = np.zeros_like(b)
    total_inner = 0
    for outer in range(1, max_outer + 1):
        with timing.span("refine.residual"):
            r = b - a_sp @ x
            relres = np.linalg.norm(r) / normb
        if relres < tol:
            return x, relres, total_inner, outer - 1
        res = solve_hierarchy(hier, r, method=method, tol=inner_tol,
                              maxiter=maxiter)
        total_inner += int(res.iterations)
        with timing.span("refine.update"):
            x = x + timing.read(res.x.double(), array=True)
    with timing.span("refine.residual"):
        r = b - a_sp @ x
        relres = np.linalg.norm(r) / normb
    return x, relres, total_inner, max_outer


def solve(a, b, config=None, device: torch.device | str = "cuda"):
    """One-call solve driven by a :class:`~..utils.config.SolveConfig`:
    the setup from its ``HierarchyConfig``, the multilevel hierarchy with
    its smoother, cycle and combination, and its Krylov method; with
    ``refine_outer > 0`` the solve is wrapped in f64 iterative refinement
    to ``refine_tol``.  ``a`` is a host CSR, ``b`` a logical-size vector;
    the work runs on ``device``, the card unless the caller asks for
    another.  Returns (x as numpy, info dict)."""
    from ..setup.aggregation import build_amg_setup
    from ..utils.config import HierarchyConfig, SolveConfig
    cfg = config or SolveConfig()
    hcfg = cfg.hierarchy or HierarchyConfig()
    dtype = torch.float64 if cfg.dtype == "float64" else torch.float32
    setup = build_amg_setup(a.to_ell(dtype=dtype, device=device), hcfg)
    sm = cfg.smoother
    hier = build_hierarchy(
        setup.matrices[0], setup.level_labels, setup.matrices[1:],
        smoother_kind=sm.kind,
        cycle="kcycle" if cfg.cycle == "kcycle" else "vcycle",
        pre_smooth=0 if cfg.cycle == "twolevel" else 1, post_smooth=1,
        combination="multiplicative" if cfg.multiplicative else "additive",
        degree=sm.degree, omega=sm.omega, sweeps=sm.sweeps,
        lmin_frac=sm.lmin_frac, inner_sweeps=sm.inner_sweeps,
        lmax_safety=sm.lmax_safety)
    if cfg.refine_outer > 0:
        x, relres, inner, outer = solve_refined(
            hier, a, b, tol=cfg.refine_tol, inner_tol=cfg.tol,
            method=cfg.method, max_outer=cfg.refine_outer,
            maxiter=cfg.max_iter)
        return x, {"relres": relres, "inner_iterations": inner,
                   "outer_sweeps": outer, "hierarchy": hier}
    res = solve_hierarchy(hier, b, method=cfg.method, tol=cfg.tol,
                          maxiter=cfg.max_iter)
    return res.x.cpu().numpy(), {"relres": res.relres,
                                 "iterations": res.iterations,
                                 "status": res.status, "hierarchy": hier}
