"""Strength-of-connection quantities for pairwise aggregation.

Per-slot, over the ELL's (K, npad) slots:

* sᵢ = −(Σⱼ≠ᵢ aᵢⱼ + Σⱼ≠ᵢ aⱼᵢ)/2;
* the G0 exclusion aᵢᵢ ≥ max(|checkdd|, κ/(κ−2)) · Σⱼ≠ᵢ|(aᵢⱼ+aⱼᵢ)/2|, the
  zerors rule and the trspos transfer (first pass only);
* the pair quality

      μ(i,j) = [2 / (1/aᵢᵢ + 1/aⱼⱼ)] /
               [ −(aᵢⱼ+aⱼᵢ)/2  +  1 / (1/(aᵢᵢ−sᵢ) + 1/(aⱼⱼ−sⱼ)) ]

  and the feasibility test aᵢᵢ − sᵢ + aⱼⱼ − sⱼ ≥ −tol.

μ is symmetric in (i, j): every subexpression is a commutative combination
of the same four coefficients, each op a separately rounded IEEE torch op,
so both endpoints of an edge compute bitwise-identical μ — the property
the handshake matching relies on.  A kernel that fuses this arithmetic
must keep it that way (no FMA contraction, no reassociation).

aⱼᵢ per slot comes from one of three routes: the symmetric configuration
(aⱼᵢ = aᵢⱼ, column sums are row sums); the union field ``a.vals_t`` of an
ELL packed ``with_transpose`` (every (j, i) is stored beside (i, j), so
aⱼᵢ and the column sums are reads of row i's own slots); or the lookup
through the transposed pattern (``sparse.ops.transposed_slot_values``,
2K + 1 K2 launches per evaluation).  The j-side fields are neighbour gathers
on K2.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..sparse import ops
from ..sparse.formats import ELL


class StrengthData(NamedTuple):
    diag: torch.Tensor       # (npad,) aᵢᵢ
    si: torch.Tensor         # (npad,) sᵢ
    excluded: torch.Tensor   # (npad,) bool — G0 ∪ trspos ∪ padding
    mu: torch.Tensor         # (K, npad) μ per stored slot (junk on invalid)
    allowed: torch.Tensor    # (K, npad) bool — pair candidate mask
    vals_t: torch.Tensor     # (K, npad) aⱼᵢ per slot
    zerors: torch.Tensor     # () bool: the zerors rule fired


def si_vector(a: ELL) -> torch.Tensor:
    """−(Σⱼ≠ᵢ aᵢⱼ + Σⱼ≠ᵢ aⱼᵢ)/2, the column terms scattered onto the row
    sums (the JAX package's compiled order)."""
    return -ops.col_sum(a, skip_diag=True,
                        init=ops.row_sum(a, skip_diag=True)) / 2.0


def nondiag_mask(a: ELL) -> torch.Tensor:
    return a.slot_mask() & (a.cols != a.row_iota())


def g0_mask(a: ELL, diag: torch.Tensor, ktg: float, checkdd: float = -0.5,
            vals_t: torch.Tensor | None = None,
            has_pair: torch.Tensor | None = None) -> torch.Tensor:
    """True for nodes excluded by diagonal dominance; ``vals_t``/
    ``has_pair`` as the caller already has them (no second lookup)."""
    abs_sum, _ = ops.symmetrized_offdiag_sums(a, vals_t, has_pair)
    return diag >= max(abs(checkdd), ktg / (ktg - 2.0)) * abs_sum


def _rel_eps(dtype: torch.dtype) -> float:
    """Relative comparison tolerance (the role of the Fortran's repsmach
    guards): aᵢᵢ − sᵢ is analytically zero on interior rows of
    conservative problems, so its floating-point sign is rounding noise."""
    return float(100 * torch.finfo(dtype).eps)


def mu_slots(a: ELL, diag: torch.Tensor, si: torch.Tensor,
             vals_t: torch.Tensor, ajj: torch.Tensor,
             s_j: torch.Tensor) -> torch.Tensor:
    """μ(i, j) for every stored slot (i → j); ``ajj``/``s_j`` are the
    gathered j-side fields.

    Evaluated as 2 / ((1/aᵢᵢ + 1/aⱼⱼ) · den) rather than
    (2 / (1/aᵢᵢ + 1/aⱼⱼ)) / den: the reference's compiled program takes
    this form (XLA's simplifier rewrites (A/B)/C to A/(B·C)), and the two
    differ in the last bit, which decides tie-breaks in the matching.
    Both forms are symmetric in (i, j)."""
    aii = diag[None, :]
    s_i = si[None, :]
    den = (-(a.vals + vals_t) / 2.0
           + 1.0 / (1.0 / (aii - s_i) + 1.0 / (ajj - s_j)))
    return 2.0 / ((1.0 / aii + 1.0 / ajj) * den)


def mu_slots_notay(a: ELL, diag: torch.Tensor, si: torch.Tensor,
                   vals_t: torch.Tensor,
                   zerors: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """AGMG 3.0's pair quality with the indefinite-case safeguards (the
    δ/η/σ formulation of ``dag2l_findpairs_GI1``) for every stored slot.

    Returns (valp, ok): ``valp`` is tested against κ, ``ok`` is False
    where the 2×2 block fails nonnegative-definiteness.  ``zerors``
    ((), bool) selects the row-sum-zero treatment of the diagonal.  The
    operations follow the reference's compiled program: ``epsr`` is
    ε·v and may be negative, and η₁η₂/(η₁+η₂) divided by g is evaluated
    as η₁η₂ / ((η₁+η₂)·g), XLA's rewrite of (A/B)/C."""
    eps_mach = torch.finfo(a.vals.dtype).eps
    aii = diag[None, :]
    ajj = ops.take_neighbor(a, diag)
    s_i = si[None, :]
    s_j = ops.take_neighbor(a, si)
    vals = -(a.vals + vals_t) / 2.0
    rsi = torch.where(zerors, 0.0, aii - s_i)
    rsj = torch.where(zerors, 0.0, ajj - s_j)
    eta1 = torch.where(zerors, 2.0 * s_i, 2.0 * aii)
    eta2 = torch.where(zerors, 2.0 * s_j, 2.0 * ajj)
    sig1 = s_i - vals
    sig2 = s_j - vals
    del1 = torch.where(sig1 > 0.0, rsi, rsi + 2.0 * sig1)
    del2 = torch.where(sig2 > 0.0, rsj, rsj + 2.0 * sig2)
    eta_num = eta1 * eta2
    eta_sum = eta1 + eta2
    epsr = eps_mach * vals
    del12 = del1 + del2
    small1 = del1.abs() < epsr
    small2 = del2.abs() < epsr
    valp_small = eta_num / (vals * eta_sum)
    valp_gen = vals + (del1 * del2) / torch.where(del12 == 0.0, 1.0, del12)
    # η₁η₂/(η₁+η₂) / g, for v > 0 (off the small cases) and v ≤ 0 alike
    valp_h = eta_num / (eta_sum
                        * torch.where(valp_gen == 0.0, 1.0, valp_gen))
    pos_ok = torch.where(
        small1 & small2, True,
        torch.where(small1, del2 >= -epsr,
                    torch.where(small2, del1 >= -epsr,
                                (del12 >= -epsr) & (valp_gen >= 0.0))))
    neg_ok = (del1 > 0.0) & (del2 > 0.0) & (valp_gen >= 0.0)
    positive = vals > 0.0
    ok = torch.where(positive, pos_ok, neg_ok)
    valp = torch.where(positive & (small1 | small2), valp_small, valp_h)
    return valp, ok


def feasible_slots(diag: torch.Tensor, si: torch.Tensor, ajj: torch.Tensor,
                   s_j: torch.Tensor) -> torch.Tensor:
    """aᵢᵢ − sᵢ + aⱼⱼ − sⱼ ≥ 0 per slot, with a relative guard."""
    lhs = diag[None, :] - si[None, :] + ajj - s_j
    tol = _rel_eps(diag.dtype) * (diag.abs()[None, :] + ajj.abs())
    return lhs >= -tol


def trspos_mask(a: ELL, diag: torch.Tensor, trspos: float) -> torch.Tensor:
    """True for nodes with a positive off-diagonal > trspos · aᵢᵢ."""
    off = a.slot_mask() & (a.cols != a.row_iota())
    pos_max = torch.where(off, a.vals, -torch.inf).amax(0)
    return pos_max > trspos * diag


def compute_strength(a: ELL, ktg: float, first_pass: bool,
                     checkdd: float = -0.5, trspos: float = 0.0,
                     fracnegrcsum: float = 0.0,
                     symmetric: bool = False,
                     mu_mode: str = "simple",
                     mu_symmetrize: bool = False) -> StrengthData:
    """All per-pass strength data.  ``first_pass=False`` disables the
    G0/trspos exclusions (later passes run on the coarse operator).
    ``symmetric`` takes aⱼᵢ = aᵢⱼ; otherwise aⱼᵢ comes from ``a.vals_t``
    where the ELL carries it, else from one transposed-pattern lookup.
    ``mu_symmetrize`` averages μ with its transposed-slot value (one more
    lookup) and allows only slots whose transposed entry is stored."""
    if mu_mode not in ("simple", "notay"):
        raise ValueError(f"unknown mu_mode {mu_mode!r}")
    diag = ops.extract_diag(a)
    # one transposed-pattern pass per evaluation at most: its values and
    # pair mask feed every consumer below
    if symmetric:
        vals_t = a.vals
        has_pair = a.slot_mask()
        si = -ops.row_sum(a, skip_diag=True)
    elif a.vals_t is not None:
        # the union pattern stores every (j, i) beside (i, j): the pair
        # always exists, and row i's column sum is Σ vals_t over its slots
        vals_t = a.vals_t
        has_pair = a.slot_mask()
        si = -ops.slot_sum(torch.where(nondiag_mask(a),
                                       (a.vals + vals_t) / 2.0, 0.0),
                           ops.union_lanes("si", a.vals.dtype))
    else:
        vals_t, has_pair = ops.transposed_slot_values(a, with_pairs=True)
        si = si_vector(a)
    # a real row lies inside the logical extent and stores an entry
    rowmask = a.row_mask() & (a.rownnz > 0)
    zerors = torch.zeros((), dtype=torch.bool, device=a.device)
    if first_pass:
        if symmetric:
            abs_sum = ops.row_sum(a, absolute=True, skip_diag=True)
            factor = max(abs(checkdd), ktg / (ktg - 2.0))
            excl = diag >= factor * abs_sum
        else:
            excl = g0_mask(a, diag, ktg, checkdd, vals_t, has_pair)
        if fracnegrcsum > 0.0:
            # zerors rule: when more than fracnegrcsum·n nodes have a
            # negative mean row+col sum, the DD exclusions are cancelled
            tol = _rel_eps(diag.dtype) * diag.abs()
            neg = ops.all_sum(a, (((diag - si) < -tol) & rowmask).sum())
            zerors = neg > fracnegrcsum * ops.all_sum(
                a, rowmask.sum()).clamp_min(1)
            excl = excl & ~zerors
        if trspos > 0.0:
            excl = excl | trspos_mask(a, diag, trspos)
    else:
        excl = torch.zeros((a.npad,), dtype=torch.bool, device=a.device)
    excl = excl | ~rowmask | (a.rownnz == 0)
    nondiag = nondiag_mask(a)
    # stored-but-zero entries are not graph edges
    edge = nondiag & ((a.vals != 0.0) | (vals_t != 0.0))
    not_excl = ~excl[None, :] & ~ops.take_neighbor(a, excl)
    if mu_mode == "notay":
        # μ ≥ 0 (not > 0), and the 2×2 test in place of feasibility
        mu, ok = mu_slots_notay(a, diag, si, vals_t, zerors)
        allowed = edge & ok & (mu >= 0.0) & (mu <= ktg) & not_excl
    else:
        ajj = ops.take_neighbor(a, diag)
        s_j = ops.take_neighbor(a, si)
        mu = mu_slots(a, diag, si, vals_t, ajj, s_j)
        allowed = (edge & (mu > 0.0) & (mu <= ktg) & not_excl
                   & feasible_slots(diag, si, ajj, s_j))
    if mu_symmetrize:
        # μ(i→j) == μ(j→i) by construction, at the cost of one more
        # transposed-pattern pass
        mu_t, has_pair = ops.transpose_slot_field(a, mu)
        mu = torch.where(has_pair, 0.5 * mu + 0.5 * mu_t, mu)
        allowed = allowed & has_pair
    return StrengthData(diag=diag, si=si, excluded=excl, mu=mu,
                        allowed=allowed, vals_t=vals_t, zerors=zerors)
