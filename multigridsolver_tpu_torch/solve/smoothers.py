"""Smoothers, all linear operators x ← x + M⁻¹(b − A x) built on SpMVs:

* weighted Jacobi and l1-Jacobi (the diagonal kinds);
* Chebyshev polynomial smoothing of the l1-Jacobi-scaled operator, which
  needs a λmax(D⁻¹A) estimate by power iteration;
* two-stage Gauss-Seidel (``gs2``): each (D + L)⁻¹ solve is replaced by a
  few Jacobi inner sweeps on the strictly triangular part, whose SpMV is
  one K1 launch on the level's split operator (:func:`split_triangular`);
* ILU(0) by the Chow–Patel fine-grained parallel factorisation (every
  stored entry's fixed-point equation updated at once, sweep after
  sweep), its two triangular solves again replaced by Jacobi inner
  sweeps.

On a row-sharded level (``parallel.shard_hierarchy``) every kind keeps
its arithmetic: its vectors hold the level's rows, and its operators (the
level's, gs2's halves, ilu0's L and U) are the level's sharded operators,
whose SpMVs run the halo, exchange or all-gather route.

The power iteration starts from the JAX package's start vector,
``jax.random.normal(PRNGKey(seed), (npad,))``, drawn again on the
operator's device (:func:`jax_normal`): twelve steps do not converge, so
the estimate, and with it the iteration counts, depend on where they
start.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from ..sparse import hybrid, ops
from ..sparse.formats import ELL
from ..utils import timing

KINDS = ("jacobi", "l1jacobi", "chebyshev", "gs2", "ilu0")


def _is_hyb(a) -> bool:
    return hasattr(a, "offsets")


def _row_mask(a) -> torch.Tensor:
    return hybrid.row_mask(a) if _is_hyb(a) else a.row_mask()


def jacobi_diag(a, l1: bool = False) -> torch.Tensor:
    """Smoothing diagonal: plain aᵢᵢ, or the l1-Jacobi safeguard
    dᵢ = aᵢᵢ + Σⱼ≠ᵢ|aᵢⱼ|; padded rows get 1."""
    if _is_hyb(a):
        d = hybrid.extract_diag(a)
        if l1:
            d = d + hybrid.row_sum_abs_offdiag(a)
    else:
        d = ops.extract_diag(a)
        if l1:
            d = d + ops.row_sum(a, absolute=True, skip_diag=True)
    return torch.where(d != 0.0, d, 1.0)


_U32 = 0xFFFFFFFF


def _threefry2x32(key, x0: torch.Tensor, x1: torch.Tensor):
    """Threefry-2x32 with 20 rounds (Salmon et al. 2011), as
    ``jax.random`` applies it, on uint32 values held in int64 tensors."""
    ks = (key[0], key[1], key[0] ^ key[1] ^ 0x1BD11BDA)
    x0, x1 = (x0 + ks[0]) & _U32, (x1 + ks[1]) & _U32
    for i in range(5):
        for r in ((13, 15, 26, 6), (17, 29, 16, 24))[i % 2]:
            x0 = (x0 + x1) & _U32
            x1 = (((x1 << r) & _U32) | (x1 >> (32 - r))) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _U32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _U32
    return x0, x1


def jax_normal(seed: int, n: int, dtype: torch.dtype,
               device: torch.device | str) -> torch.Tensor:
    """``jax.random.normal(jax.random.PRNGKey(seed), (n,), dtype)``: the
    same random bits (partitionable threefry over the element index), the
    same uniform in (−1, 1), then √2·erf⁻¹ in float64.  The JAX package
    takes erf⁻¹ from a float32 polynomial, so float32 values differ from
    its own in the last bits."""
    idx = torch.arange(n, dtype=torch.int64, device=device)
    b0, b1 = _threefry2x32((0, seed), torch.zeros_like(idx), idx)
    if dtype == torch.float32:
        f = ((((b0 ^ b1) >> 9) | 0x3F800000).to(torch.int32)
             .view(torch.float32) - 1.0)
    else:
        # the top 52 of the 64 bits (b0, b1)
        f = ((b0 << 20) | (b1 >> 12) | 0x3FF0000000000000) \
            .view(torch.float64) - 1.0
    low = torch.finfo(dtype).eps / 2.0 - 1.0     # nextafter(-1, 0)
    u = torch.clamp_min(f * (1.0 - low) + low, low)
    return (2.0 ** 0.5 * torch.special.erfinv(u.double())).to(dtype)


def estimate_lmax(a, d: torch.Tensor, iters: int = 12,
                  seed: int = 7) -> torch.Tensor:
    """Power-iteration estimate of λmax(D⁻¹A) (a 0-dim device tensor)."""
    x = torch.where(_row_mask(a), jax_normal(seed, a.npad, d.dtype,
                                             d.device), 0.0)
    dinv = 1.0 / d
    lam = torch.ones((), dtype=d.dtype, device=d.device)
    for _ in range(iters):
        y = dinv * ops.spmv(a, x)
        lam = torch.linalg.vector_norm(y)
        x = y / lam.clamp_min(1e-30)
    return lam


def chebyshev_apply(a, d: torch.Tensor, lmax: torch.Tensor,
                    b: torch.Tensor, x: torch.Tensor, degree: int,
                    lmin_frac: float) -> torch.Tensor:
    """Chebyshev iteration on D⁻¹A over [lmin_frac·λmax, λmax] (Saad,
    Iterative Methods §12.3): the three-term recurrence."""
    dinv = 1.0 / d
    lmin = lmin_frac * lmax
    theta = (lmax + lmin) / 2.0
    delta = (lmax - lmin) / 2.0
    sigma = theta / delta
    rho = 1.0 / sigma
    r = dinv * (b - ops.spmv(a, x))
    dx = r / theta
    x = x + dx
    for _ in range(degree - 1):
        r = dinv * (b - ops.spmv(a, x))
        rho_new = 1.0 / (2.0 * sigma - rho)
        dx = rho_new * rho * dx + (2.0 * rho_new / delta) * r
        x = x + dx
        rho = rho_new
    return x


def jacobi_sweeps(a, d: torch.Tensor, b: torch.Tensor, x: torch.Tensor,
                  sweeps: int, omega: float) -> torch.Tensor:
    """x ← x + ω D⁻¹ (b − A x), repeated."""
    dinv = 1.0 / d
    for _ in range(sweeps):
        x = x + omega * dinv * (b - ops.spmv(a, x))
    return x


def split_triangular(a):
    """The strictly lower and upper parts of a level operator: for a
    hybrid, two hybrids (:func:`hybrid.triangular_part`); for an ELL, two
    ELLs on its slot pattern with the values of the other slots zeroed.
    Either way each triangular SpMV is one K1 launch."""
    if _is_hyb(a):
        return (hybrid.triangular_part(a, lower=True),
                hybrid.triangular_part(a, lower=False))
    ri = a.row_iota()
    mask = a.slot_mask()
    return tuple(dataclasses.replace(
        a, vals=torch.where(mask & tri, a.vals, 0.0).contiguous(),
        vals_t=None) for tri in (a.cols < ri, a.cols > ri))


def gs2_apply(a, d: torch.Tensor, b: torch.Tensor, x: torch.Tensor,
              sweeps: int, inner: int, lower=None,
              upper=None) -> torch.Tensor:
    """Two-stage forward/backward Gauss-Seidel.  Each half-sweep needs
    z = (D + L)⁻¹ r; ``inner`` Jacobi iterations z ← D⁻¹ (r − L z) stand
    in for the triangular solve (D⁻¹L is strictly triangular, so they
    converge).  ``lower``/``upper``: the operator's strictly triangular
    parts (:func:`split_triangular`, built when not given)."""
    if lower is None or upper is None:
        lower, upper = split_triangular(a)
    dinv = 1.0 / d

    def half(x, tri):
        r = b - ops.spmv(a, x)
        z = dinv * r
        for _ in range(inner):
            z = dinv * (r - ops.spmv(tri, z))
        return x + z

    for _ in range(sweeps):
        x = half(x, lower)    # forward
        x = half(x, upper)    # backward
    return x


def ilu0_factor(a: ELL, sweeps: int = 5):
    """Chow–Patel fine-grained parallel ILU(0) on the ELL pattern.

    Solves the ILU(0) fixed-point equations

        l_ij = (a_ij − Σ_{k<j} l_ik u_kj) / u_jj        (i > j)
        u_ij =  a_ij − Σ_{k<i} l_ik u_kj                (i ≤ j)

    (sums over k with (i,k) and (k,j) both stored) by synchronous sweeps:
    every stored entry updates at once from the previous iterate, from
    l_ij = a_ij/a_jj, u_ij = a_ij.  Per sweep and slot s₁ (k = cols[s₁])
    row k's columns and upper values are fetched at once (K3; the
    columns do not change, so they are fetched with the first sweep's
    values and kept), and u_kj is matched against every target slot by
    a (K, K, n) compare.  The column diagonals are K2 gathers.

    Returns ``(lvals, uvals, udiag)``: the strictly lower and upper factor
    values on A's slot pattern (unit L diagonal implicit) and the U
    diagonal."""
    ri = a.row_iota()
    mask = a.slot_mask()
    lowmask = mask & (a.cols < ri)
    upmask = mask & (a.cols > ri)
    dgmask = mask & (a.cols == ri)
    updg = upmask | dgmask
    diag = ops.extract_diag(a)
    diag = torch.where(diag != 0.0, diag, 1.0)
    w = torch.where(lowmask, a.vals / ops.take_neighbor(a, diag), a.vals)
    w = torch.where(mask, w, 0.0)
    gates = [(a.cols[s][None, :] < torch.minimum(ri, a.cols)) & mask
             for s in range(a.k)]
    row_cols: list[torch.Tensor] = []

    def unit_diag(w):
        u = torch.where(dgmask, w, 0.0).sum(0)
        return torch.where(u != 0.0, u, 1.0)

    for _ in range(sweeps):
        lw = torch.where(lowmask, w, 0.0)          # l_ik, strict lower
        uw = torch.where(updg, w, 0.0)             # u_kj, upper incl. diag
        udiag = unit_diag(w)
        acc = torch.zeros_like(w)
        for s in range(a.k):
            k = a.cols[s]
            if len(row_cols) < a.k:
                ck, uk = ops.take_member_rows_many(k, [a.cols, uw])
                row_cols.append(ck)
            else:
                ck, uk = row_cols[s], ops.take_member_rows(k, uw)
            # u_kj matched against every target slot j = cols[s2, i]
            m = ck[:, None, :] == a.cols[None, :, :]           # (K, K, n)
            ukj = torch.where(m, uk[:, None, :], 0.0).sum(0)
            acc = acc + torch.where(gates[s], lw[s][None, :] * ukj, 0.0)
        new = a.vals - acc
        new_l = new / ops.take_neighbor(a, udiag)
        w = torch.where(lowmask, new_l, torch.where(mask, new, 0.0))
    return (torch.where(lowmask, w, 0.0), torch.where(upmask, w, 0.0),
            unit_diag(w))


def ilu_apply(a, lmat: ELL, umat: ELL, udiag: torch.Tensor, b: torch.Tensor,
              x: torch.Tensor, sweeps: int, inner: int) -> torch.Tensor:
    """x ← x + M⁻¹(b − A x) with M = L·U from :func:`ilu0_factor`.  Both
    triangular solves are Jacobi (truncated Neumann) iterations, as in
    gs2: z ← r − L z converges because L is strictly lower, likewise the
    U sweep with its diagonal scaled out.  Counts its triangular SpMVs
    (``ilu0.tri_spmv``) on the installed tracer."""
    timing.count("ilu0.tri_spmv", 2 * inner * sweeps)
    duinv = 1.0 / udiag
    for _ in range(sweeps):
        r = b - ops.spmv(a, x)
        z = r
        for _ in range(inner):
            z = r - ops.spmv(lmat, z)
        y = duinv * z
        for _ in range(inner):
            y = duinv * (z - ops.spmv(umat, y))
        x = x + y
    return x


@dataclass
class Smoother:
    """Smoother state of one level: the smoothing diagonal, the λmax
    estimate (scaled by the safety factor; 1 for every kind but
    Chebyshev), for ``ilu0`` the factors (``lmat``/``umat``: ELLs on A's
    slot pattern with the strictly lower / upper factor values; ``udiag``:
    U's diagonal), for ``gs2`` the operator's strictly triangular parts
    (``lower``/``upper``), and the kind's parameters."""

    d: torch.Tensor
    lmax: torch.Tensor
    lmat: ELL | None = None
    umat: ELL | None = None
    udiag: torch.Tensor | None = None
    lower: object | None = None
    upper: object | None = None
    kind: str = "chebyshev"
    sweeps: int = 2
    omega: float = 0.8
    degree: int = 3
    lmin_frac: float = 0.3
    inner_sweeps: int = 2

    def apply(self, a, b: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """One smoothing application: improve x for A x = b."""
        if self.kind in ("jacobi", "l1jacobi"):
            return jacobi_sweeps(a, self.d, b, x, self.sweeps, self.omega)
        if self.kind == "chebyshev":
            return chebyshev_apply(a, self.d, self.lmax, b, x, self.degree,
                                   self.lmin_frac)
        if self.kind == "gs2":
            return gs2_apply(a, self.d, b, x, self.sweeps, self.inner_sweeps,
                             self.lower, self.upper)
        if self.kind == "ilu0":
            return ilu_apply(a, self.lmat, self.umat, self.udiag, b, x,
                             self.sweeps, self.inner_sweeps)
        raise ValueError(f"unknown smoother kind {self.kind!r}")

    def solve(self, a, b: torch.Tensor) -> torch.Tensor:
        """M⁻¹ b (zero initial guess): the smoother as a preconditioner."""
        return self.apply(a, b, torch.zeros_like(b))


def make_smoother(a, kind: str = "chebyshev", sweeps: int = 2,
                  omega: float = 0.8, degree: int = 3,
                  lmin_frac: float = 0.3, inner_sweeps: int = 2,
                  lmax_safety: float = 1.1, ell: ELL | None = None,
                  factor_sweeps: int = 5, lmax: float | None = None,
                  state: dict | None = None,
                  level: int | None = None) -> Smoother:
    """The smoother of ``kind`` for the level operator ``a``.

    ``ell``: the pure-ELL view of ``a`` that ``ilu0`` factors (``a``
    itself may be the DIA+ELL hybrid); defaults to ``a`` when it is an
    ELL.  ``lmax``: a given Chebyshev λmax (safety factor included), for
    example carried over from another implementation; estimated by power
    iteration when None.  ``state``: tensors carried over in place of the
    computed ones: ``d``, and for ``ilu0`` the factors ``lvals``,
    ``uvals``, ``udiag``.  ``level``: the level the factorisation's span
    (``ilu0.factor``) is recorded at."""
    if kind not in KINDS:
        raise ValueError(f"unknown smoother kind {kind!r}; one of {KINDS}")
    state = state or {}
    d = state.get("d")
    if d is None:
        d = jacobi_diag(a, l1=kind in ("l1jacobi", "chebyshev"))
    if kind != "chebyshev":
        lam = torch.ones((), dtype=d.dtype, device=d.device)
    elif lmax is None:
        lam = estimate_lmax(a, d) * lmax_safety
    else:
        lam = torch.tensor(lmax, dtype=d.dtype, device=d.device)
    sm = Smoother(d=d, lmax=lam, kind=kind, sweeps=sweeps, omega=omega,
                  degree=degree, lmin_frac=lmin_frac,
                  inner_sweeps=inner_sweeps)
    if kind == "gs2":
        sm.lower, sm.upper = split_triangular(a)
    elif kind == "ilu0":
        src = ell if ell is not None else a
        if _is_hyb(src):
            raise ValueError("ilu0 needs the pure-ELL operator: pass ell= "
                             "when a is a DIA+ELL hybrid")
        if "lvals" in state:
            lvals, uvals, udiag = (state[k] for k in ("lvals", "uvals",
                                                      "udiag"))
        else:
            with timing.span("ilu0.factor", level):
                lvals, uvals, udiag = ilu0_factor(src, sweeps=factor_sweeps)
        sm.lmat = dataclasses.replace(src, vals=lvals, vals_t=None)
        sm.umat = dataclasses.replace(src, vals=uvals, vals_t=None)
        sm.udiag = udiag
    return sm
