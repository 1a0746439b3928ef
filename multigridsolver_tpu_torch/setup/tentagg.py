"""checktentagg: the Napov–Notay quality re-check of tentative merges.

On a further pass (s ≥ 2), before two existing aggregates merge, AGMG
3.x tests the merged aggregate in the round's input operator: over the
union G of their fine members it builds the symmetrised block W,

    W ← A_G − (2/κ)·D_G + (2 / (κ·1ᵀD_G1)) · D_G 1 1ᵀ D_G

(with the σ_G correction for negative external sums), and accepts the
merge iff W is nonnegative definite: a Cholesky whose pivots all stay
positive.  A rejected pair's edge leaves the allowed mask and the
handshake matching runs again, so each endpoint proposes to its next
best neighbour (``aggregation.match_pass_checked``).

Everything is batched over the coarse leaders: every fine node knows its
aggregate, its rank in it, and the tentative merge (leader) and side it
belongs to; every stored entry inside one merge scatters aᵢⱼ/2 into
W[lead, slot_i, slot_j] and W[lead, slot_j, slot_i], and the D×D algebra
(D = 2·km) runs on the (ncp, D, D) batch.  W is float32 whatever the
operator's dtype, as in the JAX package.

The bits of the verdicts: W's scatters add at most two terms onto 0, so
their order cannot matter; the row sums over D are folded in slot order,
and (1 − 2/κ)·dᵢ − |σᵢ| and W + (c·vᵢ)·vⱼ are fused multiply-adds, as
the JAX CPU program computes them (measured on its intermediates); the
Cholesky follows OpenBLAS's unblocked ``potf2`` as the JAX package
reaches it through LAPACK's ``spotrf`` on the CPU (OpenBLAS 0.3.30,
whose ``spotrf`` stays unblocked up to 32×32), measured on its
intermediates: pivot j is aⱼⱼ minus the strided ``sdot`` of row j, which
takes the row in pairs, fma(x₀, x₀, x₁²), fma(x₂, x₂, x₃²), …, widens
each pair to float64, sums them there in order (an odd last term as
x²) and rounds the sum once to float32; each column below it is aᵢⱼ
minus ``sgemv_n``'s sum, times the reciprocal of the pivot's root (root
and reciprocal correctly rounded).  ``sgemv_n``'s sum is a forward fma
chain over k, except with exactly four columns (j = 4), where its 4×4
kernel takes the first multiple of four rows below the pivot and adds
two chains, fma(x₂, y₂, x₀y₀) + fma(x₃, y₃, x₁y₁); the rest of those
rows keep the chain.  That order reproduces ``spotrf`` bit for bit, its
verdicts and every factor entry, on near-singular blocks up to 20×20,
so every checked pass (D = 2·km ≤ 16) takes the JAX package's verdicts
(``tests/test_torch_multihost_tentagg.py``).  The fused multiply-adds
are evaluated in float64 (the product of two float32 values is exact
there), so the CPU and the card give the same bits.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..sparse import ops
from ..sparse.formats import ELL

# a pivot within this fraction of the largest diagonal of its W counts
# as near zero in the verdict log
NEAR_ZERO = 1e-5


def member_ranks(labels: torch.Tensor, km: int,
                 nagg: int | None = None) -> torch.Tensor:
    """rank[i] = position of fine node i within its aggregate (0-based, by
    ascending fine index), clipped to km − 1; 0 for excluded nodes.  km − 1
    rounds of scatter-min, each extracting every aggregate's smallest
    remaining member.  ``nagg``: a bound on the labels (default npad;
    over ranks the labels of a rank's rows reach past its npad)."""
    npad = labels.shape[0]
    nagg = npad if nagg is None else nagg
    dev = labels.device
    idxs = torch.arange(npad, dtype=torch.int32, device=dev)
    valid = labels >= 0
    lab = torch.where(valid, labels, nagg).long()
    remaining = valid
    rank = torch.zeros((npad,), dtype=torch.int32, device=dev)
    for r in range(km - 1):
        m = torch.full((nagg + 1,), npad, dtype=torch.int32, device=dev)
        m.scatter_reduce_(0, lab, torch.where(remaining, idxs, npad),
                          "amin")
        taken = remaining & (m[lab] == idxs)
        rank = torch.where(taken, r, rank)
        remaining = remaining & ~taken
    return torch.where(remaining & valid, km - 1, rank).to(torch.int32)


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32 fma(a, b, c) through float64, where a·b is exact."""
    return (a.double() * b.double() + c.double()).float()


def _pair_dot(x: torch.Tensor) -> torch.Tensor:
    """Σₖ x[..., k]² as OpenBLAS's strided ``sdot`` adds it: pairs
    fma(x₀, x₀, x₁²) summed in float64, an odd last term as x², one
    rounding to float32 at the end (see the module docstring)."""
    n = x.shape[-1]
    t = torch.zeros(x.shape[:-1], dtype=torch.float64, device=x.device)
    for k in range(0, n - 1, 2):
        t = t + _fma(x[..., k], x[..., k], x[..., k + 1] * x[..., k + 1]) \
            .double()
    if n % 2:
        t = t + (x[..., n - 1] * x[..., n - 1]).double()
    return t.float()


def _gemv_sum(rows: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Σₖ rows[:, i, k]·x[:, k] for the column below a pivot, as
    OpenBLAS's ``sgemv_n`` adds it: a forward fma chain over k, but with
    exactly four columns its 4×4 kernel takes the first multiple of four
    rows, fma(r₂, x₂, r₀x₀) + fma(r₃, x₃, r₁x₁)."""
    n = x.shape[-1]
    xs = x[:, None, :]
    t = rows.new_zeros(rows.shape[:2])
    for k in range(n):
        t = _fma(rows[..., k], xs[..., k], t)
    m4 = rows.shape[1] & -4
    if n == 4 and m4:
        r, xk = rows[:, :m4], xs
        two = (_fma(r[..., 2], xk[..., 2], r[..., 0] * xk[..., 0])
               + _fma(r[..., 3], xk[..., 3], r[..., 1] * xk[..., 1]))
        t = torch.cat([two, t[:, m4:]], 1)
    return t


def cholesky_pivots(w: torch.Tensor) -> torch.Tensor:
    """The pivots (the squares of diag(L)) of a lower Cholesky of each
    symmetric float32 ``w`` (B, D, D), D ≤ 16, in ``spotrf``'s order;
    past a non-positive pivot the rest are junk.  Returns (B, D)."""
    d = w.shape[-1]
    lo = w.clone()
    piv = []
    for j in range(d):
        p = lo[:, j, j] - _pair_dot(lo[:, j, :j])
        piv.append(p)
        # the root and the reciprocal through float64, rounded once more
        # to float32: that gives the correctly rounded float32 result, which
        # torch's float32 sqrt on the CPU does not always give
        ljj = torch.sqrt(p.double()).float()
        lo[:, j, j] = ljj
        if j + 1 < d:
            t = _gemv_sum(lo[:, j + 1:, :j], lo[:, j, :j])
            inv = (1.0 / ljj.double()).float()
            lo[:, j + 1:, j] = (lo[:, j + 1:, j] - t) * inv[:, None]
    return torch.stack(piv, 1)


def _fold(x: torch.Tensor) -> torch.Tensor:
    """Σ over the last axis, folded in order."""
    acc = torch.zeros_like(x[..., 0])
    for k in range(x.shape[-1]):
        acc = acc + x[..., k]
    return acc


class NodeMaps(NamedTuple):
    """Where every node sits in the tentative merges of one pass."""

    lead_c: torch.Tensor     # (ncp,) coarse node → its merge's leader
    haspair_c: torch.Tensor  # (ncp,) coarse node has a partner
    lab_ok: torch.Tensor     # (npad,) fine node is aggregated
    lead_f: torch.Tensor     # (npad,) fine node → its merge's leader
    inpair_f: torch.Tensor   # (npad,) fine node belongs to a merge
    slot_f: torch.Tensor     # (npad,) fine node's row/column of W


def member_counts(labels: torch.Tensor, ncp: int, mesh) -> torch.Tensor:
    """(world, ncp) uint8: how many members of each aggregate every rank
    holds (``labels`` this rank's rows; one all-gather of ncp bytes).  An
    aggregate has at most 2·km ≤ 16 members."""
    lab_ok = labels >= 0
    here = torch.zeros((ncp + 1,), dtype=torch.int32, device=labels.device)
    here.index_add_(0, torch.where(lab_ok, labels, ncp).long(),
                    lab_ok.to(torch.int32))
    return mesh.comm.all_gather(here[:ncp].to(torch.uint8)) \
        .view(mesh.world, ncp)


def node_maps(labels: torch.Tensor, paired: torch.Tensor, km: int,
              counts: torch.Tensor | None = None,
              rank: int = 0) -> NodeMaps:
    """The coarse fields of ``paired`` pulled through ``labels`` to the fine
    nodes (plain gathers, as in the JAX package): a merge's leader is its
    smaller coarse node, whose members take W's slots 0..km−1 and the
    partner's members slots km..2km−1, by rank.

    Over ranks ``labels`` holds this rank's rows and ``counts`` every
    rank's member counts (:func:`member_counts`): a member's rank within
    its aggregate is its rank among this rank's members plus the members
    the lower ranks hold, so the slots are the one-process ones even
    where an aggregate's members lie on several ranks."""
    ncp = paired.shape[0]
    cnodes = torch.arange(ncp, dtype=torch.int32, device=paired.device)
    partner_c = torch.where(paired >= 0, paired, cnodes)
    haspair_c = (paired >= 0) & (partner_c != cnodes)
    lead_c = torch.minimum(cnodes, partner_c)
    rank_f = member_ranks(labels, km, max(ncp, labels.shape[0]))
    lab_ok = labels >= 0
    safe_lab = torch.where(lab_ok, labels, 0).long()
    if counts is not None and rank:
        below = counts[:rank].to(torch.int32).sum(0)
        rank_f = torch.where(lab_ok, rank_f + below[safe_lab], rank_f) \
            .clamp_max(km - 1)
    lead_f = lead_c[safe_lab]
    inpair_f = haspair_c[safe_lab] & lab_ok
    side_f = torch.where(labels == lead_f, 0, 1)
    slot_f = (rank_f + km * side_f).clamp(0, 2 * km - 1).to(torch.int32)
    return NodeMaps(lead_c, haspair_c, lab_ok, lead_f, inpair_f, slot_f)


def _sum_spanning(w, sig, valid, paired, counts, mesh):
    """Over ranks: complete W, σ and the member mask of every merge whose
    members lie on more than one rank, by one all-reduce of those blocks
    (each entry has at most two nonzero terms, so the sum is order-free;
    the mask travels as float32 counts).  Returns (w, sig, valid, held):
    ``held`` (ncp,) marks the merges this rank holds members of, whose
    blocks are now whole here."""
    ncp, d = sig.shape
    cnodes = torch.arange(ncp, dtype=torch.int32, device=paired.device)
    partner_c = torch.where(paired >= 0, paired, cnodes).long()
    tested = (paired >= 0) & (partner_c != cnodes) & (cnodes < partner_c)
    counts = counts.to(torch.int32)
    holds = ((counts + counts[:, partner_c]) > 0) & tested[None, :]
    spanning = torch.nonzero(holds.sum(0) > 1).view(-1)
    if spanning.numel():
        buf = torch.cat([w[spanning].reshape(-1, d * d), sig[spanning],
                         valid[spanning].to(torch.float32)], 1)
        buf = mesh.allreduce_sum(buf)
        w = w.index_copy(0, spanning, buf[:, :d * d].view(-1, d, d))
        sig = sig.index_copy(0, spanning, buf[:, d * d:d * d + d])
        valid = valid.index_copy(0, spanning, buf[:, d * d + d:] > 0)
    return w, sig, valid, holds[mesh.rank]


def checktentagg(a0: ELL, si0: torch.Tensor, labels: torch.Tensor,
                 ac: ELL, paired: torch.Tensor, ktg: float,
                 zerors: torch.Tensor, km: int,
                 log: list | None = None) -> torch.Tensor:
    """Accept or reject every tentative pair at once.

    ``a0``/``si0``: the round's input operator and its first pass's sᵢ;
    ``labels``: fine → current coarse labels before this pass; ``ac``:
    the current coarse operator; ``paired``: this pass's tentative
    pairing of the coarse nodes; ``km``: the most members an existing
    aggregate has (2^(s−1)).  Returns (ncp,) bool: True where a node's
    pair passes or it has none; both endpoints read the leader's verdict.

    ``log``: a list that receives one dict of device scalars (tentative
    pairs, rejected pairs, pairs whose smallest pivot is within
    ``NEAR_ZERO`` of W's largest diagonal), read by nothing here.

    Over ranks (``a0`` a rank's rows of the round's input, ``si0``,
    ``labels`` and ``zerors`` its rows too; ``ac`` and ``paired``
    whole): every rank scatters its own rows into W, the merges whose
    members lie on several ranks are summed over the ranks
    (:func:`_sum_spanning`), each rank tests every merge it holds
    members of, and one all-reduce (max) of a byte per coarse node hands
    every rank every verdict, so that all ranks match alike.  Three
    collectives a call: the member counts (ncp bytes), the spanning
    blocks and the verdicts (ncp bytes)."""
    ncp = paired.shape[0]
    dev = paired.device
    d = 2 * km
    cnodes = torch.arange(ncp, dtype=torch.int32, device=dev)
    mesh = ops.rank_mesh(a0)
    counts = None if mesh is None else member_counts(labels, ncp, mesh)
    lead_c, haspair_c, lab_ok, lead_f, inpair_f, slot_f = node_maps(
        labels, paired, km, counts, 0 if mesh is None else mesh.rank)

    # neighbour-side maps per stored slot (K2; the bool field as bytes)
    lead_j = ops.take_neighbor(a0, lead_f)
    slot_j = ops.take_neighbor(a0, slot_f).clamp(0, d - 1)
    labok_j = ops.take_neighbor(a0, lab_ok)
    internal = (a0.slot_mask() & inpair_f[None, :] & labok_j
                & (lead_j == lead_f[None, :]))
    offd = internal & (a0.cols != a0.row_iota())

    # W, σ and the member mask by scatters into (ncp + 1) leaders, the
    # last one a dump; at most two terms land on any entry of W
    vals32 = a0.vals.to(torch.float32)
    half = torch.where(offd, vals32 / 2.0, 0.0).reshape(-1)
    tgt = torch.where(offd, lead_f[None, :].long(), ncp)
    si_b = slot_f[None, :].long().expand_as(tgt)
    sj_b = slot_j.long()
    w = torch.zeros(((ncp + 1) * d * d,), dtype=torch.float32, device=dev)
    w.index_add_(0, ((tgt * d + si_b) * d + sj_b).reshape(-1), half)
    w.index_add_(0, ((tgt * d + sj_b) * d + si_b).reshape(-1), half)
    diag0 = ops.extract_diag(a0).to(torch.float32)
    si32 = si0.to(torch.float32)
    dvals = torch.where(zerors, si32, diag0)
    mslot = torch.where(inpair_f, slot_f, 0).long()
    mlead = torch.where(inpair_f, lead_f, ncp).long()
    w.index_add_(0, (mlead * d + mslot) * d + mslot,
                 torch.where(inpair_f, dvals, 0.0))
    sig = torch.zeros(((ncp + 1) * d,), dtype=torch.float32, device=dev)
    sig.index_add_(0, mlead * d + mslot, torch.where(inpair_f, si32, 0.0))
    valid = torch.zeros(((ncp + 1) * d,), dtype=torch.int32, device=dev)
    valid.index_add_(0, mlead * d + mslot, inpair_f.to(torch.int32))
    w = w.view(ncp + 1, d, d)[:ncp]
    sig = sig.view(ncp + 1, d)[:ncp]
    valid = valid.view(ncp + 1, d)[:ncp] > 0
    if mesh is not None:
        w, sig, valid, held = _sum_spanning(w, sig, valid, paired, counts,
                                            mesh)

    # the D×D quality algebra, batched over the leaders
    eps = 100 * torch.finfo(torch.float32).eps
    eye = torch.eye(d, dtype=torch.bool, device=dev)[None]
    diagw = torch.diagonal(w, dim1=1, dim2=2)
    offsum = _fold(w) - diagw
    # AGe takes the original sᵢ, before σ absorbs the internal sums
    age0 = torch.where(zerors, 0.0, diagw - sig)
    sig = sig + offsum
    age = torch.where(sig < 0.0, age0 + 2.0 * sig, age0)
    v = torch.where(valid, diagw, 0.0)
    umd = torch.full_like(diagw, 1.0 - 2.0 / ktg)
    new_diag = _fma(umd, diagw, -sig.abs())
    w = torch.where(eye, new_diag[:, :, None], w)
    beta = _fold(v)
    beta_safe = torch.where(beta == 0.0, 1.0, beta)
    coef = torch.full_like(beta_safe, 2.0 / ktg) / beta_safe
    w = _fma(coef[:, None, None] * v[:, :, None], v[:, None, :], w)
    # invalid slots become identity rows; in the near-singular case (A_G
    # has the constant vector in its null space) the last valid member
    # too, so the test runs on the leading (d−1) block
    alp = torch.where(valid, age.abs(), 0.0).amax(1)
    nvalid = valid.sum(1)
    singular = alp < eps * coef.abs()
    sl = torch.arange(d, device=dev)[None, :]
    last_valid = torch.where(valid, sl, -1).amax(1)
    keep = valid & ~(singular[:, None] & (sl == last_valid[:, None]))
    cross = keep[:, :, None] & keep[:, None, :]
    w = torch.where(cross, w, 0.0)
    w = torch.where(eye & ~keep[:, :, None], 1.0, w)
    # LAPACK's caller symmetrises its input first
    w = (w + w.transpose(1, 2)) / 2.0
    piv = cholesky_pivots(w)
    ok = ((piv > 0.0) & torch.isfinite(piv)).all(1)
    acc = ok | ~haspair_c | (nvalid <= 1)
    tested = haspair_c & (lead_c == cnodes)
    scale = torch.diagonal(w, dim1=1, dim2=2).abs().amax(1)
    near = (nvalid > 1) & (piv.abs().amin(1) <= NEAR_ZERO * scale)
    if mesh is not None:
        # each merge's verdict from a rank that holds its members (a rank
        # that holds none reads 0; where several hold them, they agree)
        code = torch.where(held, acc.to(torch.uint8)
                           + 2 * near.to(torch.uint8), 0).to(torch.uint8)
        code = mesh.allreduce_max(code)
        acc = torch.where(tested, (code & 1) > 0, acc)
        near = (code & 2) > 0
    if log is not None:
        log.append(dict(pairs=tested.sum(), rejected=(tested & ~acc).sum(),
                        near_zero=(tested & near).sum()))
    # both endpoints read the leader's verdict (K2, bool as bytes)
    acc_all = ops.take_neighbor(ac, acc, idx=lead_c[None, :])[0]
    return torch.where(haspair_c, acc_all, True)
