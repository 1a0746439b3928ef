"""Krylov solvers: right-preconditioned BiCGStab, preconditioned CG,
flexible CG and restarted GMRES.

BiCGStab follows the IML++ template formulation of the reference,
including its status codes (0 converged, 1 max-iter, 2 ρ-breakdown,
3 ω-breakdown), its convergence test ‖r‖/‖b‖ < tol and its mid-iteration
early exit on ‖s‖.  Flexible CG, truncated to the last two directions, is
the outer method AGMG pairs with K-cycles (whose inner FCG makes the
preconditioner vary).  GMRES(m) reduces its Hessenberg matrix by Givens
rotations, which give the residual at every Arnoldi step.

Each iteration (for GMRES each Arnoldi step) reads the device once,
through ``utils/timing.read`` (a ``krylov.read`` span when a tracer is
installed), and so does the first residual.
On a row mesh over ranks every dot product and norm is a local one
all-reduced: the caller passes the mesh's sum over ranks as ``allsum``
(the identity when it is None, where norms are ``vector_norm``), and
every rank takes the same branches on the same reduced scalars.  For
BiCGStab the breakdown and convergence flags of the whole iteration come
back in one small tensor: the second half-step (precondition s,
multiply, ω) is computed before the early-exit test is known, and when
the exit fires that work is discarded, exactly as if it had not run.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import scipy.linalg
import torch

from ..utils import timing


class SolveResult(NamedTuple):
    x: torch.Tensor
    iterations: int
    relres: float      # achieved ‖r‖/‖b‖
    status: int        # 0 ok; 1 maxiter; 2 rho-breakdown; 3 omega=0


def _norm(v: torch.Tensor) -> torch.Tensor:
    return torch.linalg.vector_norm(v)


def _reductions(allsum: Callable | None):
    """(dot, norm) over the rows of every rank: torch's on one process,
    the local ones summed by ``allsum`` over ranks."""
    if allsum is None:
        return torch.dot, _norm
    return (lambda u, v: allsum(torch.dot(u, v)),
            lambda v: torch.sqrt(allsum(torch.dot(v, v))))


def _read(t: torch.Tensor):
    """One device read of the loop (``timing.read``, span
    ``krylov.read``)."""
    return timing.read(t, "krylov.read")


def _nz(x: torch.Tensor) -> torch.Tensor:
    """Guard exact-zero denominators (breakdowns are caught separately)."""
    tiny = 1e-300 if x.dtype == torch.float64 else 1e-30
    return torch.where(x == 0.0, tiny, x)


def bicgstab(matvec: Callable, b: torch.Tensor,
             precond: Callable | None = None, x0: torch.Tensor | None = None,
             tol: float = 1e-6, maxiter: int = 10000,
             allsum: Callable | None = None) -> SolveResult:
    """Right-preconditioned BiCGStab (IML++ semantics)."""
    if precond is None:
        precond = lambda v: v
    dot, norm = _reductions(allsum)
    x = torch.zeros_like(b) if x0 is None else x0
    normb = norm(b)
    normb = torch.where(normb == 0.0, 1.0, normb)
    r = b - matvec(x)
    rtilde = r
    resid = _read(norm(r) / normb)
    if resid <= tol:
        return SolveResult(x=x, iterations=0, relres=resid, status=0)
    p = v = None
    rho_2 = alpha = omega = None
    for i in range(1, maxiter + 1):
        rho_1 = dot(rtilde, r)
        if i == 1:
            p = r
        else:
            beta = (rho_1 / _nz(rho_2)) * (alpha / _nz(omega))
            p = r + beta * (p - omega * v)
        phat = precond(p)
        v = matvec(phat)
        alpha = rho_1 / _nz(dot(rtilde, v))
        s = r - alpha * v
        resid_s = norm(s) / normb
        shat = precond(s)
        t = matvec(shat)
        omega_new = dot(t, s) / _nz(dot(t, t))
        r_new = s - omega_new * t
        resid_new = norm(r_new) / normb
        flags = _read(torch.stack([
            (rho_1 == 0.0).to(resid_s.dtype), resid_s, resid_new,
            (omega_new == 0.0).to(resid_s.dtype),
            norm(r) / normb]))
        rho_zero, rs, rn, om_zero, resid_r = flags
        if rho_zero:
            return SolveResult(x=x, iterations=i + 1, relres=resid_r,
                               status=2)
        if rs < tol:
            return SolveResult(x=x + alpha * phat, iterations=i, relres=rs,
                               status=0)
        x = x + alpha * phat + omega_new * shat
        r, omega, rho_2 = r_new, omega_new, rho_1
        if rn < tol:
            return SolveResult(x=x, iterations=i, relres=rn, status=0)
        if om_zero:
            return SolveResult(x=x, iterations=i, relres=rn, status=3)
        resid = rn
    return SolveResult(x=x, iterations=maxiter, relres=resid, status=1)


def cg(matvec: Callable, b: torch.Tensor, precond: Callable | None = None,
       x0: torch.Tensor | None = None, tol: float = 1e-6,
       maxiter: int = 10000, allsum: Callable | None = None) -> SolveResult:
    """Standard preconditioned CG (fixed preconditioner); one device read
    (the residual norm) per iteration."""
    if precond is None:
        precond = lambda v: v
    dot, norm = _reductions(allsum)
    x = torch.zeros_like(b) if x0 is None else x0
    normb = norm(b)
    normb = torch.where(normb == 0.0, 1.0, normb)
    r = b - matvec(x)
    z = precond(r)
    p = z
    rz = dot(r, z)
    resid = _read(norm(r) / normb)
    i = 0
    while resid >= tol and i < maxiter:
        ap = matvec(p)
        alpha = rz / _nz(dot(p, ap))
        x = x + alpha * p
        r = r - alpha * ap
        z = precond(r)
        rz_new = dot(r, z)
        p = z + (rz_new / _nz(rz)) * p
        rz = rz_new
        i += 1
        resid = _read(norm(r) / normb)
    return SolveResult(x=x, iterations=i, relres=resid,
                       status=0 if resid < tol else 1)


def fcg(matvec: Callable, b: torch.Tensor, precond: Callable | None = None,
        x0: torch.Tensor | None = None, tol: float = 1e-6,
        maxiter: int = 10000, truncate: int = 2,
        allsum: Callable | None = None) -> SolveResult:
    """Flexible CG with truncated orthogonalisation (Notay's FCG): each
    new direction is made A-orthogonal to the last ``truncate`` ones, so a
    varying preconditioner such as a K-cycle is allowed.  One device read
    (the residual norm) per iteration."""
    if precond is None:
        precond = lambda v: v
    dot, norm = _reductions(allsum)
    sums = allsum or (lambda t: t)
    x = torch.zeros_like(b) if x0 is None else x0
    normb = norm(b)
    normb = torch.where(normb == 0.0, 1.0, normb)
    r = b - matvec(x)
    hp = b.new_zeros((truncate, b.shape[0]))
    hap = torch.zeros_like(hp)
    hden = b.new_ones((truncate,))
    hok = torch.zeros((truncate,), dtype=torch.bool, device=b.device)
    resid = _read(norm(r) / normb)
    i = 0
    while resid >= tol and i < maxiter:
        z = precond(r)
        betas = torch.where(hok, sums(hap @ z) / hden, 0.0)
        p = z - betas @ hp
        ap = matvec(p)
        den = dot(p, ap)
        alpha = dot(p, r) / _nz(den)
        x = x + alpha * p
        r = r - alpha * ap
        # the newest direction first, the oldest dropped
        hp = torch.cat([p[None], hp[:-1]])
        hap = torch.cat([ap[None], hap[:-1]])
        hden = torch.cat([_nz(den)[None], hden[:-1]])
        hok = torch.cat([hok.new_ones((1,)), hok[:-1]])
        i += 1
        resid = _read(norm(r) / normb)
    return SolveResult(x=x, iterations=i, relres=resid,
                       status=0 if resid < tol else 1)


def gmres(matvec: Callable, b: torch.Tensor, precond: Callable | None = None,
          x0: torch.Tensor | None = None, tol: float = 1e-6,
          maxiter: int = 1000, restart: int = 30,
          allsum: Callable | None = None) -> SolveResult:
    """Right-preconditioned restarted GMRES(m), m = ``restart``.

    Arnoldi with modified Gram-Schmidt on the device; the Hessenberg
    column of each step comes back in one read, and its Givens rotations
    (the textbook QR, in the vectors' precision) run on the host.  They
    give the residual |g[j+1]|/‖b‖ after every step, so a restart stops at
    the step that meets ``tol`` and credits that many iterations; the
    correction is x += Σⱼ yⱼ zⱼ over those steps, y from the triangular
    system of the rotated columns.  ``relres`` is that implicit
    residual."""
    if precond is None:
        precond = lambda v: v
    dot, norm = _reductions(allsum)
    m = restart
    x = torch.zeros_like(b) if x0 is None else x0
    dt = np.float32 if b.dtype == torch.float32 else np.float64
    normb_t = norm(b)
    normb_t = torch.where(normb_t == 0.0, 1.0, normb_t)
    r = b - matvec(x)
    normb, beta0 = (dt(v) for v in _read(torch.stack([normb_t, norm(r)])))
    resid = dt(beta0 / normb)
    iters = 0
    while resid >= tol and iters < maxiter:
        r = b - matvec(x)
        beta = norm(r)
        basis = [r / torch.where(beta == 0.0, 1.0, beta)]
        zs = []
        rmat = np.zeros((m + 1, m), dtype=dt)
        g = np.zeros(m + 1, dtype=dt)
        cs = np.zeros(m, dtype=dt)
        sn = np.zeros(m, dtype=dt)
        done_at = m
        for j in range(m):
            z = precond(basis[j])
            w = matvec(z)
            hs = []
            for v in basis:            # modified Gram-Schmidt
                hij = dot(v, w)
                w = w - hij * v
                hs.append(hij)
            hjj = norm(w)
            basis.append(w / torch.where(hjj == 0.0, 1.0, hjj))
            zs.append(z)
            read = torch.stack(hs + [hjj] + ([beta] if j == 0 else []))
            hcol = np.zeros(m + 1, dtype=dt)
            vals = np.asarray(_read(read), dtype=dt)
            hcol[: j + 2] = vals[: j + 2]
            if j == 0:
                g[0] = vals[-1]
            for i in range(j):         # the earlier rotations
                hi = cs[i] * hcol[i] + sn[i] * hcol[i + 1]
                hi1 = -sn[i] * hcol[i] + cs[i] * hcol[i + 1]
                hcol[i], hcol[i + 1] = hi, hi1
            denom = np.sqrt(hcol[j] * hcol[j] + hcol[j + 1] * hcol[j + 1])
            c = dt(1.0) if denom == 0.0 else hcol[j] / denom
            s = dt(0.0) if denom == 0.0 else hcol[j + 1] / denom
            hcol[j], hcol[j + 1] = denom, dt(0.0)
            g[j], g[j + 1] = c * g[j], -s * g[j]
            cs[j], sn[j] = c, s
            rmat[:, j] = hcol
            resid = dt(abs(g[j + 1]) / normb)
            if resid < tol:
                done_at = j + 1
                break
        y = scipy.linalg.solve_triangular(rmat[:done_at, :done_at],
                                          g[:done_at], lower=False)
        x = x + torch.from_numpy(np.ascontiguousarray(y, dtype=dt)).to(
            b.device) @ torch.stack(zs[:done_at])
        iters += done_at
    return SolveResult(x=x, iterations=iters, relres=float(resid),
                       status=0 if resid < tol else 1)
