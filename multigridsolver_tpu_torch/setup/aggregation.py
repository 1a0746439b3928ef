"""Multi-pass pairwise aggregation and the full multilevel setup.

  pass 1:  strength + G0 exclusion on A, matching → labels¹ (n → nc₁)
  pass s:  strength on the coarse matrix A̅ (no exclusions), matching →
           pass labels (nc₋₁ → nc), composed into the fine labels; with
           ``check_tentagg`` every tentative merge is re-tested in A
           (``tentagg.checktentagg``) and rejected pairs re-matched
  early exit when nnz(A̅) ≤ nnz(A)/τ or the coarse grid is smaller than
  ``max_restriction``; ``skipass_frac``: when the excluded rows alone
  coarsen enough, pass 1 forms no pair and one extra pass compensates.

``build_amg_setup`` repeats such rounds level after level until the
coarsest operator fits a dense direct solve, with ``smooth_p`` each
level's P smoothed and its operator the triple product P_sᵀ A P_s;
``refresh_setup`` reuses a setup's aggregation for new values on the
same pattern.  The host reads back ``nc`` per pass, ``nnz``/max degree
per Galerkin product and one flag per matching round; everything else
stays on the device.  ``matching="greedy"`` (the reference CPU
algorithm) takes float64 strength on the device and matches on the host,
in the C++ runtime (:func:`_greedy_pass`).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field

import numpy as np
import torch

from ..sparse import ops as ell_ops
from ..sparse.formats import ELL
from ..utils.config import AggregationConfig, HierarchyConfig
from ..utils import timing
from .galerkin import galerkin_ell, galerkin_pair_ell
from .matching import labels_from_pairs, mutual_match
from .prolongation import compose_labels
from .smoothed import galerkin_general, smoothed_prolongation
from .strength import compute_strength
from .tentagg import checktentagg

# match → checktentagg → re-match rounds of a checked pass
CHECK_RETRIES = 3


@dataclass
class PassInfo:
    nc: int
    nnz: int
    # checked passes: per retry, checktentagg's log (device scalars)
    checks: list | None = None


@dataclass
class AggregationResult:
    labels: torch.Tensor         # (npad,) fine row → final aggregate (or -1)
    nc: int
    coarse: ELL                  # final coarse operator of this round
    passes: list[PassInfo] = field(default_factory=list)


@dataclass
class SetupResult:
    """Per-level operators and labels; with smoothed aggregation also the
    explicit P and Pᵀ per level (``p_ops``/``pt_ops``, None otherwise)
    and the ω they were smoothed with."""

    matrices: list[ELL]                # level operators, finest first
    level_labels: list[torch.Tensor]   # labels level l → level l+1
    rounds: list[AggregationResult] = field(default_factory=list)
    p_ops: list[ELL] | None = None
    pt_ops: list[ELL] | None = None
    smooth_omega: float | None = None


MATCHINGS = ("mutual", "greedy")


def _check_supported(cfg: AggregationConfig) -> None:
    if cfg.matching not in MATCHINGS:
        raise ValueError(f"unknown matching {cfg.matching!r}; one of "
                         f"{MATCHINGS}")


def paired_from_labels_host(labels_np: np.ndarray) -> np.ndarray:
    """The pair array of pairwise labels (host): the two members of a
    label are each other's partners, a singleton is its own, an excluded
    node (−1) has none (−1)."""
    n = labels_np.shape[0]
    paired = np.full(n, -1, np.int64)
    order = np.argsort(labels_np, kind="stable")
    lab_sorted = labels_np[order]
    first = np.ones(n, bool)
    first[1:] = lab_sorted[1:] != lab_sorted[:-1]
    starts = np.flatnonzero(first)
    sizes = np.diff(np.append(starts, n))
    real = lab_sorted[starts] >= 0
    if (sizes[real] > 2).any():
        raise ValueError("labels are not pairwise")
    single = order[starts[real & (sizes == 1)]]
    paired[single] = single
    lead = starts[real & (sizes == 2)]
    paired[order[lead]] = order[lead + 1]
    paired[order[lead + 1]] = order[lead]
    return paired


def _greedy_pass(a: ELL, first_pass: bool, cfg: AggregationConfig):
    """One pass of the reference CPU algorithm: float64 strength on the
    device (on ``a``'s values; a carried ``vals_t`` enters as it is), the
    CSR, G0 exclusions, diagonal and sᵢ copied to the host, then the CMK
    order (first pass; index order after) and the exact sequential greedy
    matching in the C++ runtime.  Returns (paired, labels, nc), the
    labels (npad,) int32 back on ``a``'s device."""
    from ..io.native import cmk_order_native, greedy_pass_native
    csr = a.to_csr()
    n = csr.nrows
    st = compute_strength(dataclasses.replace(a, vals=a.vals.double()),
                          cfg.ktg, first_pass, checkdd=cfg.checkdd,
                          trspos=cfg.trspos, fracnegrcsum=cfg.fracnegrcsum)
    excluded = timing.read(st.excluded[:n], array=True)
    si = timing.read(st.si[:n], array=True)
    diag = timing.read(st.diag[:n], array=True)
    if first_pass:
        order = cmk_order_native(csr, genuine=cfg.cmk_mode == "genuine")
    else:
        order = np.arange(n)
    labels_np = np.full(a.npad, -1, np.int32)
    labels_np[:n] = greedy_pass_native(csr, diag, si, excluded, order,
                                       cfg.ktg)
    nc = int(labels_np.max()) + 1 if (labels_np >= 0).any() else 0
    paired = torch.from_numpy(paired_from_labels_host(labels_np)
                              .astype(np.int32)).to(a.device)
    return paired, torch.from_numpy(labels_np).to(a.device), nc


def match_pass(a: ELL, first_pass: bool, cfg: AggregationConfig):
    """Strength + handshake matching + labelling of one pass (skipass on a
    first pass).  Returns (paired, labels, nc, strength)."""
    st = compute_strength(a, cfg.ktg, first_pass, checkdd=cfg.checkdd,
                          trspos=cfg.trspos, fracnegrcsum=cfg.fracnegrcsum,
                          symmetric=cfg.symmetric, mu_mode=cfg.mu_mode)
    paired = mutual_match(a, st, max_rounds=cfg.max_matching_rounds,
                          skipass_frac=cfg.skipass_frac if first_pass
                          else 0.0)
    labels, nc = labels_from_pairs(paired, st.excluded, a)
    return paired, labels, nc, st


def match_pass_checked(mat: ELL, a0: ELL, si0: torch.Tensor,
                       cum_labels: torch.Tensor, zerors: torch.Tensor,
                       cfg: AggregationConfig, km: int):
    """A further pass over ``mat`` with checktentagg: match, test every
    tentative merge in ``a0`` (the round's input operator, with its first
    pass's ``si0`` and ``zerors``), drop the failed pairs' edges and match
    again, ``CHECK_RETRIES`` times; pairs still failing become singletons.
    Returns (paired, labels, nc, checks): ``checks`` holds checktentagg's
    log of each retry."""
    st = compute_strength(mat, cfg.ktg, False, checkdd=cfg.checkdd,
                          trspos=cfg.trspos, fracnegrcsum=cfg.fracnegrcsum,
                          symmetric=cfg.symmetric, mu_mode=cfg.mu_mode)
    nodes = torch.arange(mat.npad, dtype=torch.int32, device=mat.device)
    allowed = st.allowed
    checks: list = []
    for _ in range(CHECK_RETRIES):
        paired = mutual_match(mat, st._replace(allowed=allowed),
                              max_rounds=cfg.max_matching_rounds)
        acc = checktentagg(a0, si0, cum_labels, mat, paired, float(cfg.ktg),
                           zerors, km, log=checks)
        fail = ~acc & (paired >= 0) & (paired != nodes)
        partner = torch.where(paired >= 0, paired, -1)
        allowed = allowed & ~(fail[None, :] & (mat.cols == partner[None, :]))
    paired = torch.where(fail, nodes, paired)
    labels, nc = labels_from_pairs(paired, st.excluded, mat)
    return paired, labels, nc, checks


def pairwise_aggregate(a: ELL, cfg: AggregationConfig,
                       nnz0: int | None = None) -> AggregationResult:
    """One setup round: ``cfg.npass`` pairwise passes over ``a`` (one more
    when skipass fired).  ``nnz0``: the host-known nnz of ``a`` (read from
    the device if None).  Each pass is a span ``aggregation.pass<s>`` of
    the installed tracer (``utils/timing``).  The greedy matching takes
    neither checktentagg nor skipass (as in the JAX package)."""
    _check_supported(cfg)
    greedy = cfg.matching == "greedy"
    if nnz0 is None:
        nnz0 = timing.read(ell_ops.all_sum(a, a.rownnz.sum()))

    with timing.span("aggregation.pass1"):
        if greedy:
            paired, labels, nc = _greedy_pass(a, True, cfg)
        else:
            paired, labels, nc, st = match_pass(a, True, cfg)
        extra = 0
        if cfg.skipass_frac > 0.0 and not greedy:
            # skipass fired: pass 1 paired nothing; one extra pass
            # compensates
            nodes = a.row_ids()
            extra = int(not ell_ops.all_any(
                a, (paired >= 0) & (paired != nodes)))
        ac, nnz_c = galerkin_pair_ell(a, paired, labels, nc)
    cum_labels = labels
    passes = [PassInfo(nc=nc, nnz=nnz_c)]
    for s in range(2, cfg.npass + extra + 1):
        if nnz_c <= nnz0 / cfg.tou:
            break
        if cfg.max_restriction and ac.nrows < cfg.max_restriction:
            break
        km = 2 ** (s - 1)
        checks = None
        with timing.span(f"aggregation.pass{s}"):
            if greedy:
                paired, pass_labels, nc = _greedy_pass(ac, False, cfg)
            elif (cfg.check_tentagg and km <= 8
                  and a.global_npad % 1024 == 0):
                paired, pass_labels, nc, checks = match_pass_checked(
                    ac, a, st.si, cum_labels, st.zerors, cfg, km)
            else:
                paired, pass_labels, nc, _ = match_pass(ac, False, cfg)
            ac, nnz_c = galerkin_pair_ell(ac, paired, pass_labels, nc)
        cum_labels = compose_labels(cum_labels, pass_labels)
        passes.append(PassInfo(nc=nc, nnz=nnz_c, checks=checks))
    return AggregationResult(labels=cum_labels, nc=nc, coarse=ac,
                             passes=passes)


def build_amg_setup(a: ELL, cfg: HierarchyConfig) -> SetupResult:
    """Coarsen until the coarsest level fits a dense direct solve; with
    ``cfg.smooth_p`` each level's P is smoothed with that ω and its
    coarse operator is the triple product."""
    mats = [a]
    labels: list[torch.Tensor] = []
    rounds: list[AggregationResult] = []
    p_ops: list[ELL] = []
    pt_ops: list[ELL] = []
    cur, cur_nnz = a, None
    for _ in range(cfg.max_levels - 1):
        if cur.nrows <= cfg.max_coarse_size:
            break
        res = pairwise_aggregate(cur, cfg.aggregation, nnz0=cur_nnz)
        if res.nc == 0 or res.nc >= cur.nrows:
            break   # no coarsening progress
        coarse, cur_nnz = res.coarse, res.passes[-1].nnz
        if cfg.smooth_p is not None:
            ps = smoothed_prolongation(cur, res.labels, res.nc,
                                       omega=float(cfg.smooth_p))
            coarse, pt = galerkin_general(cur, ps)
            p_ops.append(ps)
            pt_ops.append(pt)
            cur_nnz = None      # the triple product changes the nnz
        labels.append(res.labels)
        mats.append(coarse)
        rounds.append(res)
        cur = coarse
    smoothed = cfg.smooth_p is not None
    return SetupResult(matrices=mats, level_labels=labels, rounds=rounds,
                       p_ops=p_ops if smoothed else None,
                       pt_ops=pt_ops if smoothed else None,
                       smooth_omega=float(cfg.smooth_p) if smoothed
                       else None)


def refresh_setup(prev: SetupResult, a: ELL) -> SetupResult:
    """A setup for new values on the previous finest operator's pattern:
    the aggregation (labels, level structure) is kept and only the coarse
    values are recomputed, by ``galerkin_ell`` on the kept labels, or for
    a smoothed setup by smoothing P again and the triple product.  Only
    ``a.vals`` is read."""
    prev_fine = prev.matrices[0]
    if (a.cols.shape != prev_fine.cols.shape
            or (a.nrows, a.ncols) != (prev_fine.nrows, prev_fine.ncols)):
        raise ValueError(
            "refresh_setup requires the previous operator's pattern "
            f"(shape {tuple(prev_fine.cols.shape)}/{prev_fine.nrows} vs "
            f"{tuple(a.cols.shape)}/{a.nrows})")
    cur = dataclasses.replace(prev_fine, vals=a.vals)
    mats = [cur]
    if prev.p_ops is not None:
        # P_s depends on A's values: smooth the kept labels again
        omega = prev.smooth_omega if prev.smooth_omega is not None \
            else 2.0 / 3.0
        p_ops, pt_ops = [], []
        for l, lab in enumerate(prev.level_labels):
            ps = smoothed_prolongation(cur, lab, prev.matrices[l + 1].nrows,
                                       omega=omega)
            cur, pt = galerkin_general(cur, ps)
            p_ops.append(ps)
            pt_ops.append(pt)
            mats.append(cur)
        return SetupResult(matrices=mats, level_labels=prev.level_labels,
                           rounds=prev.rounds, p_ops=p_ops, pt_ops=pt_ops,
                           smooth_omega=omega)
    for l, lab in enumerate(prev.level_labels):
        cur = galerkin_ell(cur, lab, prev.matrices[l + 1].nrows)
        mats.append(cur)
    return SetupResult(matrices=mats, level_labels=prev.level_labels,
                       rounds=prev.rounds)
