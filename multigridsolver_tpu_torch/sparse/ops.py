"""Core sparse operations on the slot-major padded ELL.

Reductions over a row's slots are reductions over axis 0.  Every gather
goes through the kernels of :mod:`..ops.gather`: neighbour fields through
K2 (K4 on a row-sharded ELL), member-row fetches through K3 (one launch
per member set), SpMV through
K1 (``gather_spmv`` for an ELL, ``hyb_spmv`` for a DIA+ELL hybrid).
"""
from __future__ import annotations

import torch

from ..ops import gather
from ..utils import timing
from .formats import ELL


def take_neighbor(a: ELL, x: torch.Tensor,
                  idx: torch.Tensor | None = None) -> torch.Tensor:
    """Gather the per-neighbour field ``x[idx]`` (idx defaults to
    ``a.cols``) — the hot access pattern of strength, matching and
    Galerkin (K2).

    On a row-sharded ELL (``a.shard`` set) each shard exchanges its
    boundary slabs with its mesh neighbours and gathers on K4 instead;
    the covered range holds every stored column and the shard's own rows,
    so any index drawn from those (partner proposals, pair indices,
    leaders) is served.  On a rank's rows whose halo would exceed a shard
    (``h`` None) the field is all-gathered and K2 gathers from the whole
    of it.

    Entries at invalid slots (slot ≥ rownnz[i], padding rows) and at
    out-of-range indices are unspecified: every consumer masks them.
    ``x``: (m,) of 4- or 8-byte words (float32/float64/int32/int64) or
    bool; on a sharded ELL m = npad.  K2 and K4 gather a bool field as
    its bytes.
    """
    if idx is None:
        idx = a.cols
    if a.shard is None:
        return gather.take(idx.contiguous(), x.contiguous())
    mesh, npr, h = a.shard
    x = x.contiguous()
    if h is None:
        return gather.take(idx.contiguous(), mesh.gather_rows(x))
    return gather.take_sharded(idx.contiguous(), x, mesh.boundary_halo(x, h),
                               npr, h, base=a.row0)


def rank_mesh(a):
    """The row mesh over ranks whose rows of ``a`` this rank holds, or
    None (``a`` whole in this process)."""
    shard = getattr(a, "shard", None)
    if shard is None or not shard[0].over_ranks:
        return None
    return shard[0]


def all_sum(a, t: torch.Tensor) -> torch.Tensor:
    """A sum over ``a``'s rows: ``t`` summed over the ranks that hold
    them (``t`` itself when ``a`` is whole)."""
    mesh = rank_mesh(a)
    return t if mesh is None else mesh.allreduce_sum(t)


def all_any(a, t: torch.Tensor) -> bool:
    """``t.any()`` over all of ``a``'s rows, read on the host (a
    collective read over ranks)."""
    mesh = rank_mesh(a)
    t = t.any()
    return bool(timing.read(t if mesh is None else mesh.allreduce_max(t)))


def bin_counts(idx: torch.Tensor, length: int) -> torch.Tensor:
    """``torch.bincount(idx, minlength=length)`` for ``idx`` in [0,
    ``length``) (int64), without the read of ``idx.max()`` that
    ``bincount`` makes on the card."""
    idx = idx.long()
    return torch.zeros((length,), dtype=torch.int64,
                       device=idx.device).scatter_add_(
        0, idx, torch.ones_like(idx))


def take_member_rows(members: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """``out[s, c] = xs[s, members[c]]`` — whole slot rows fetched at
    member indices (the Galerkin pair merge, K3)."""
    if xs.dtype == torch.bool:
        return gather.take_rows(members.contiguous(),
                                xs.to(torch.int32)) != 0
    return gather.take_rows(members.contiguous(), xs.contiguous())


def take_member_rows_many(members: torch.Tensor, sources) -> list:
    """:func:`take_member_rows` of up to four sources (each ``(S_m, n)``
    of 4- or 8-byte words) in one K3 launch."""
    return gather.take_rows_many(members.contiguous(),
                                 [xs.contiguous() for xs in sources])


def spmv(a, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x for an ELL (K1), a DIA+ELL hybrid (K1's ``hyb_spmv``,
    lanes and remainder in one launch), or a row-sharded operator bound to
    its mesh (``parallel.HaloOp``/``ExchangeELL``: halo and index-list
    exchanges, then one ``hyb_spmv_sharded`` launch).  ``x``: the padded
    column vector; invalid slots hold val 0, so no masking is needed.  A
    sharded ELL's ``x`` is the whole vector here, on one device, so its
    SpMV is the plain K1 one; an ELL holding a rank's rows of a mesh over
    ranks that is bound to no route has none (``parallel.shard_hierarchy``
    and ``parallel.bind_operator`` bind such an operator to its mesh,
    which then carries its route: halo, exchange or all-gather)."""
    if hasattr(a, "mesh"):
        return a.spmv(x)
    if rank_mesh(a) is not None:
        raise NotImplementedError("an ELL holding a rank's rows has no "
                                  "SpMV of its own; bind its level to the "
                                  "mesh (parallel.shard_hierarchy)")
    if hasattr(a, "offsets"):
        from . import hybrid
        return hybrid.spmv(a, x)
    return gather.gather_spmv(a.cols, a.vals, x.contiguous())


def spmv_t(a: ELL, y: torch.Tensor, out_size: int) -> torch.Tensor:
    """x = Aᵀ y by scatter-add over the stored slots (no transpose is
    materialised)."""
    contrib = a.vals * y[None, : a.npad]
    out = torch.zeros((out_size,), dtype=contrib.dtype, device=a.device)
    return out.index_add_(0, a.cols.reshape(-1).long(), contrib.reshape(-1))


def extract_diag(a: ELL) -> torch.Tensor:
    """(npad,) diagonal; 0 where a row stores no diagonal entry."""
    isdiag = (a.cols == a.row_iota()) & a.slot_mask()
    return torch.where(isdiag, a.vals, 0.0).sum(0)


# XLA:CPU splits a reduction over more than this many slots into windows
# of this size (its tree-reduction rewrite)
XLA_WINDOW = 32


def slot_sum(v: torch.Tensor, lanes=None) -> torch.Tensor:
    """Σ over the slot axis of a (K, npad) field, in the order the JAX
    package's compiled program adds on the CPU.  The last bit of these sums
    decides the strength tests (G0, feasibility, μ ties), and ``v.sum(0)``
    adds in other orders (on the CPU past 16 slots, and on the card).

    Past 32 slots XLA reduces windows of 32 (the padding to a whole number
    of windows split evenly before and after), each folded in order, and
    folds the windows in order.  Up to 32, a fold in slot order, unless
    ``lanes`` (a function of K, as :func:`union_lanes` returns) gives the
    vectorised loop LLVM made of that reduction: ``(vf, uf, epi)`` =
    ``uf`` accumulators of ``vf`` lanes over the first whole blocks of
    vf·uf slots (slot s in accumulator (s // vf) % uf, lane s % vf), the
    accumulators added in order, the lanes halved pairwise, then an
    ``epi``-lane loop (0: none) seeded with that sum, then the rest slot
    by slot.  Every step is an elementwise add, so the card gives the
    same bits."""
    k = v.shape[0]
    if k > XLA_WINDOW:
        pad = -k % XLA_WINDOW
        edges = list(range(-(pad // 2), k, XLA_WINDOW))
        return _fold([_fold(v[max(lo, 0):lo + XLA_WINDOW])
                      for lo in edges])
    plan = lanes(k) if lanes is not None else None
    if plan is None:
        return _fold(v)
    vf, uf, epi = plan
    block = vf * uf
    main = k // block * block
    acc = None
    for u in range(uf):
        part = _fold([v[b + u * vf:b + (u + 1) * vf]
                      for b in range(0, main, block)])
        acc = part if acc is None else acc + part
    acc = _halve(acc)
    if epi and k - main >= epi:
        tail = k - (k - main) % epi
        seeded = torch.zeros_like(v[:epi])
        seeded[0] = acc
        for b in range(main, tail, epi):
            seeded = seeded + v[b:b + epi]
        acc, main = _halve(seeded), tail
    for row in v[main:]:
        acc = acc + row
    return acc


def _fold(rows):
    acc = torch.zeros_like(rows[0])
    for row in rows:
        acc = acc + row
    return acc


def _halve(lanes: torch.Tensor) -> torch.Tensor:
    while lanes.shape[0] > 1:
        h = lanes.shape[0] // 2
        lanes = lanes[:h] + lanes[h:]
    return lanes[0]


# The loops LLVM made of the union field's two slot sums in the JAX
# package's pass program (``_match_pass``) on an x86-64 CPU with AVX-512,
# measured by ``tools/xla_slot_order.py``: (first K, last K, (vf, uf, epi))
# by sum and value type; every other K up to 32 is folded in slot order.
_LANES = {
    ("si", torch.float32): ((23, 23, (8, 1, 4)), (24, 32, (8, 1, 0))),
    ("abs", torch.float32): ((20, 23, (4, 4, 4)), (24, 32, (8, 1, 0))),
    ("si", torch.float64): ((23, 23, (4, 4, 4)), (24, 31, (4, 2, 0)),
                            (32, 32, (4, 4, 0))),
    ("abs", torch.float64): ((20, 23, (4, 4, 4)), (24, 31, (4, 2, 0)),
                             (32, 32, (4, 4, 0))),
}


def union_lanes(which: str, dtype: torch.dtype):
    """``slot_sum``'s ``lanes`` for the union sᵢ sum (``"si"``) or the G0
    sum Σ|(aᵢⱼ + aⱼᵢ)/2| (``"abs"``) of a ``dtype`` field."""
    spans = _LANES[which, dtype]

    def lanes(k: int):
        for lo, hi, plan in spans:
            if lo <= k <= hi:
                return plan
        return None
    return lanes


def row_sum(a: ELL, absolute: bool = False,
            skip_diag: bool = False) -> torch.Tensor:
    """Σⱼ aᵢⱼ per row (optionally |aᵢⱼ|, optionally without the diagonal)."""
    v = a.vals.abs() if absolute else a.vals
    if skip_diag:
        v = torch.where(a.cols == a.row_iota(), 0.0, v)
    # padding slots already hold 0
    return slot_sum(v)


def col_sum(a: ELL, absolute: bool = False, skip_diag: bool = False,
            init: torch.Tensor | None = None) -> torch.Tensor:
    """Σᵢ aᵢⱼ per column, by scatter-add over the stored slots, onto a copy
    of ``init`` (zeros by default).  ``x + col_sum(a)`` compiles in the
    JAX package to ``col_sum(a, init=x)`` (the add folded into the
    scatter), and the two differ in the last bit."""
    v = a.vals.abs() if absolute else a.vals
    mask = a.slot_mask()
    if skip_diag:
        mask = mask & (a.cols != a.row_iota())
    return _scatter_cols(a, torch.where(mask, v, 0.0), init)


def _scatter_cols(a: ELL, v: torch.Tensor,
                  init: torch.Tensor | None) -> torch.Tensor:
    mesh = rank_mesh(a)
    if mesh is not None:
        return _scatter_cols_ranks(a, v, init, mesh)
    out = (torch.zeros((a.npad,), dtype=v.dtype, device=v.device)
           if init is None else init.clone())
    return out.index_add_(0, a.cols.reshape(-1).long(), v.reshape(-1))


def _scatter_cols_ranks(a: ELL, v: torch.Tensor, init, mesh) -> torch.Tensor:
    """:func:`_scatter_cols` on a rank's rows: the neighbour ranks' ``h``
    boundary rows (cols and ``v``) come in through the row halo, and the
    rows ``[row0 − h, row0 + nloc + h)`` scatter in slot-major order onto
    the rank's own columns (the rest into a dump slot), so each column
    adds the same terms in the same order as the whole scatter.  Where
    the halo would exceed a shard (``h`` None) every rank's rows are
    all-gathered and scattered whole."""
    h, n, r0 = a.shard[2], a.npad, a.row0
    if h is None:
        cols, vv = mesh.gather_rows(a.cols), mesh.gather_rows(v)
        out = torch.zeros((cols.shape[1],), dtype=v.dtype, device=v.device)
        if init is not None:
            out[r0:r0 + n] = init
        out.index_add_(0, cols.reshape(-1).long(), vv.reshape(-1))
        return out[r0:r0 + n].clone()
    parts_c, parts_v = [a.cols], [v]
    left_c, right_c = mesh.row_halo(a.cols, h)
    left_v, right_v = mesh.row_halo(v, h)
    dump = n + 2 * h
    if h:
        # a missing neighbour's rows scatter into the dump
        parts_c = [left_c if left_c is not None
                   else a.cols.new_full((a.k, h), r0 - h - 1),
                   a.cols,
                   right_c if right_c is not None
                   else a.cols.new_full((a.k, h), r0 - h - 1)]
        parts_v = [left_v if left_v is not None else v.new_zeros((a.k, h)),
                   v,
                   right_v if right_v is not None else v.new_zeros((a.k, h))]
    cols = torch.cat(parts_c, 1).long() - (r0 - h)
    cols = torch.where((cols >= 0) & (cols < n + 2 * h), cols, dump)
    out = torch.zeros((dump + 1,), dtype=v.dtype, device=v.device)
    if init is not None:
        out[h:h + n] = init
    out.index_add_(0, cols.reshape(-1), torch.cat(parts_v, 1).reshape(-1))
    return out[h:h + n].clone()


def _transposed_lookup(a: ELL, field: torch.Tensor | None = None):
    """For every stored slot (i → j): row j's entry of ``field`` at the
    slot that stores column i (0 where row j stores no column i; None
    without a field), and the pair-exists mask (before the slot mask).

    A loop over the K source slots s₂: each step gathers one (K, npad)
    plane, ``cols[s₂]`` (and ``field[s₂]``) at j = ``a.cols`` on K2, and
    accumulates where the column is i, so the live memory stays O(K·n).
    At most one source slot hits, so the sum is exact; it runs in
    ascending s₂, as in the JAX package."""
    ri = a.row_iota()
    nnz_j = take_neighbor(a, a.rownnz)
    acc = None if field is None else torch.zeros(
        a.cols.shape, dtype=field.dtype, device=a.device)
    has = torch.zeros(a.cols.shape, dtype=torch.bool, device=a.device)
    for s2 in range(a.k):
        hit = (take_neighbor(a, a.cols[s2]) == ri) & (s2 < nnz_j)
        if field is not None:
            acc = acc + torch.where(hit, take_neighbor(a, field[s2]), 0)
        has = has | hit
    return acc, has


def transposed_slot_values(a: ELL, with_pairs: bool = False):
    """(K, npad) t with t[s, i] = A[j, i] for j = cols[s, i] (0 where the
    transposed entry is not stored); ``with_pairs`` also returns the
    pair-exists mask from the same loop."""
    vals_t, hit = _transposed_lookup(a, a.vals)
    if with_pairs:
        return vals_t, hit & a.slot_mask()
    return vals_t


def pair_exists(a: ELL) -> torch.Tensor:
    """(K, npad) bool: True where the transposed entry (j, i) is stored."""
    return _transposed_lookup(a)[1] & a.slot_mask()


def transpose_slot_field(a: ELL, field: torch.Tensor):
    """(field_t, has_pair): field_t[s, i] = field[s', j] where slot (s, i)
    stores column j and slot (s', j) stores column i (0 where there is no
    such slot); has_pair marks the slots whose transposed entry is
    stored."""
    acc, has = _transposed_lookup(a, field)
    return acc, has & a.slot_mask()


def symmetrized_offdiag_sums(a: ELL, vals_t: torch.Tensor | None = None,
                             has_pair: torch.Tensor | None = None):
    """Per row (Σⱼ≠ᵢ |(aᵢⱼ + aⱼᵢ)/2|,  Σⱼ≠ᵢ (aᵢⱼ + aⱼᵢ)/2) over the union of
    the patterns of row i and column i: a shared entry contributes once,
    an entry stored in only one direction contributes |a|/2.

    ``vals_t``/``has_pair``: the transposed values and pair mask where the
    caller has them.  With the union field (``a.vals_t``) every term is a
    read of row i's own slots; otherwise the lone transposed entries are
    scattered onto their columns."""
    union = a.vals_t is not None
    if vals_t is None:
        if union:
            vals_t, has_pair = a.vals_t, a.slot_mask()
        else:
            vals_t, has_pair = transposed_slot_values(a, with_pairs=True)
    offdiag = a.slot_mask() & (a.cols != a.row_iota())
    sym = (a.vals + vals_t) / 2.0
    abs_from_rows = slot_sum(torch.where(offdiag, sym.abs(), 0.0),
                             union_lanes("abs", sym.dtype) if union else None)
    if union:
        return abs_from_rows, slot_sum(torch.where(offdiag, sym, 0.0),
                                       union_lanes("si", sym.dtype))
    # an entry (i, j) stored while (j, i) is not contributes |aᵢⱼ|/2 to
    # row j's union pattern
    lone = torch.where(offdiag & ~has_pair, a.vals.abs() / 2.0, 0.0)
    plain = col_sum(a, skip_diag=True, init=row_sum(a, skip_diag=True)) / 2.0
    return _scatter_cols(a, lone, abs_from_rows), plain


def get_element(a: ELL, i: torch.Tensor, j: torch.Tensor) -> torch.Tensor:
    """Random element access A[i, j], elementwise over index tensors of
    one shape (0 where (i, j) is not stored).  An index gather on whole
    slot columns, as in the JAX package (an XLA take there, no Pallas
    kernel)."""
    cols_i = a.cols[:, i]                     # (K, ...)
    vals_i = a.vals[:, i]
    nnz_i = a.rownnz[i]
    sl = torch.arange(a.k, dtype=torch.int32, device=a.device)
    sl = sl.reshape((a.k,) + (1,) * i.dim())
    hit = (cols_i == j[None, ...]) & (sl < nnz_i[None, ...])
    return torch.where(hit, vals_i, 0.0).sum(0)


def to_dense(a: ELL) -> torch.Tensor:
    """(nrows, ncols) dense materialisation (small matrices only)."""
    out = torch.zeros((a.npad, a.ncols), dtype=a.vals.dtype, device=a.device)
    v = torch.where(a.slot_mask(), a.vals, 0.0)
    out.index_put_((a.row_iota().reshape(-1).long(),
                    a.cols.reshape(-1).long()), v.reshape(-1),
                   accumulate=True)
    return out[: a.nrows]
