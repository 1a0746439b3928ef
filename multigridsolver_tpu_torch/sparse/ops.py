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
    leaders) is served.

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
    return gather.take_sharded(idx.contiguous(), x, mesh.boundary_halo(x, h),
                               npr, h)


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
    SpMV is the plain K1 one."""
    if hasattr(a, "mesh"):
        return a.spmv(x)
    if hasattr(a, "offsets"):
        from . import hybrid
        return hybrid.spmv(a, x)
    return gather.gather_spmv(a.cols, a.vals, x.contiguous())


def extract_diag(a: ELL) -> torch.Tensor:
    """(npad,) diagonal; 0 where a row stores no diagonal entry."""
    isdiag = (a.cols == a.row_iota()) & a.slot_mask()
    return torch.where(isdiag, a.vals, 0.0).sum(0)


def row_sum(a: ELL, absolute: bool = False,
            skip_diag: bool = False) -> torch.Tensor:
    """Σⱼ aᵢⱼ per row (optionally |aᵢⱼ|, optionally without the diagonal)."""
    v = a.vals.abs() if absolute else a.vals
    if skip_diag:
        v = torch.where(a.cols == a.row_iota(), 0.0, v)
    # padding slots already hold 0
    return v.sum(0)


def col_sum(a: ELL, absolute: bool = False,
            skip_diag: bool = False) -> torch.Tensor:
    """Σᵢ aᵢⱼ per column, by scatter-add over the stored slots."""
    v = a.vals.abs() if absolute else a.vals
    mask = a.slot_mask()
    if skip_diag:
        mask = mask & (a.cols != a.row_iota())
    v = torch.where(mask, v, 0.0)
    out = torch.zeros((a.npad,), dtype=v.dtype, device=v.device)
    return out.index_add_(0, a.cols.reshape(-1).long(), v.reshape(-1))


def to_dense(a: ELL) -> torch.Tensor:
    """(nrows, ncols) dense materialisation (small matrices only)."""
    out = torch.zeros((a.npad, a.ncols), dtype=a.vals.dtype, device=a.device)
    v = torch.where(a.slot_mask(), a.vals, 0.0)
    out.index_put_((a.row_iota().reshape(-1).long(),
                    a.cols.reshape(-1).long()), v.reshape(-1),
                   accumulate=True)
    return out[: a.nrows]
