"""Grid transfers on the K1 gather-SpMV kernel.

* Prolongation is a K = 1 gather whose indices are the labels themselves
  (unit weights, 0 for nodes outside the coarse space).
* Restriction is a gather from the coarse side: a members-ELL whose row c
  lists the fine indices of aggregate c in ascending order,
  (Pᵀ v)[c] = Σ_m v[members[m, c]] — no scatter, no atomics.
* A weighted plan (smoothed aggregation) takes an explicit P and its
  transpose: prolongation is P's own K1 SpMV over the coarse vector,
  restriction Pᵀ's over the fine one.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from ..ops import gather
from ..sparse import ops
from ..sparse.formats import ELL, _round_up
from ..utils import timing

T = 1024   # row padding of every operator


@dataclass
class TransferPlan:
    """K1-ready transfer operators of one level: ``p_*`` gather over the
    fine rows from the coarse vector, ``m_*`` over the coarse rows from
    the fine vector."""

    p_cols: torch.Tensor    # (1, npad_f) int32
    p_vals: torch.Tensor    # (1, npad_f)
    m_cols: torch.Tensor    # (km, nc_t) int32
    m_vals: torch.Tensor    # (km, nc_t)
    npad_f: int
    nc_pad: int
    # an explicit (smoothed) P: the labels do not describe it
    weighted: bool = False


def _members_ell(labels: torch.Tensor, nc_t: int, dtype: torch.dtype):
    """cols[r, c] = fine index of the r-th member of aggregate c in
    ascending fine order (0 beyond the aggregate's size, with val 0)."""
    npad = labels.shape[0]
    dev = labels.device
    valid = labels >= 0
    lab = torch.where(valid, labels, nc_t).long()
    counts = ops.bin_counts(lab, nc_t + 1)[:nc_t]
    km = max(timing.read(counts.max()) if nc_t else 0, 1)
    # members grouped by aggregate, ascending fine index inside a group
    order = torch.sort(lab, stable=True).indices
    lab_s = lab[order]
    start = torch.cumsum(counts, 0) - counts
    start = torch.cat([start, start.new_zeros(1)])     # dump aggregate nc_t
    rank = torch.arange(npad, device=dev) - start[lab_s]
    ok = lab_s < nc_t
    cols = torch.zeros((km, nc_t + 1), dtype=torch.int32, device=dev)
    vals = torch.zeros((km, nc_t + 1), dtype=dtype, device=dev)
    r = torch.where(ok, rank, 0)
    c = torch.where(ok, lab_s, nc_t)
    cols.index_put_((r, c), order.to(torch.int32))
    vals.index_put_((r, c), ok.to(dtype))
    return cols[:, :nc_t].contiguous(), vals[:, :nc_t].contiguous()


def build_transfer_plan(labels: torch.Tensor, nc_pad: int,
                        dtype: torch.dtype) -> TransferPlan:
    """Both directions' K1 arrays from a level's (npad,) label vector."""
    npad = labels.shape[0]
    npad_f = _round_up(npad, T)
    nc_t = _round_up(nc_pad, T)
    if npad_f != npad:
        labels = torch.cat([labels, labels.new_full((npad_f - npad,), -1)])
    valid = labels >= 0
    p_cols = torch.where(valid, labels, 0).to(torch.int32)[None, :]
    p_vals = valid.to(dtype)[None, :]
    m_cols, m_vals = _members_ell(labels, nc_t, dtype)
    return TransferPlan(p_cols=p_cols.contiguous(), p_vals=p_vals.contiguous(),
                        m_cols=m_cols, m_vals=m_vals, npad_f=npad_f,
                        nc_pad=nc_pad)


def build_transfer_plan_from_p(p: ELL, pt: ELL, nc_pad: int) -> TransferPlan:
    """A weighted plan from an explicit prolongation ELL ``p`` (n × nc)
    and its transpose ``pt``, each with rows padded to a multiple of
    1024."""
    p, pt = repad_rows(p), repad_rows(pt)
    return TransferPlan(p_cols=p.cols, p_vals=p.vals, m_cols=pt.cols,
                        m_vals=pt.vals, npad_f=p.npad, nc_pad=nc_pad,
                        weighted=True)


def repad_rows(e: ELL) -> ELL:
    """``e`` with its rows padded (empty) to a multiple of 1024."""
    extra = _round_up(e.npad, T) - e.npad
    if extra == 0:
        return e
    return dataclasses.replace(
        e, cols=torch.nn.functional.pad(e.cols, (0, extra)),
        vals=torch.nn.functional.pad(e.vals, (0, extra)),
        rownnz=torch.nn.functional.pad(e.rownnz, (0, extra)))


def prolong_fast(tp: TransferPlan, xc: torch.Tensor,
                 out_len: int) -> torch.Tensor:
    """P @ xc on K1 (a level sharded over ranks: ``parallel.
    RankTransfer``, bound to its mesh)."""
    if hasattr(tp, "mesh"):
        return tp.prolong(xc, out_len)
    return gather.gather_spmv(tp.p_cols, tp.p_vals, xc)[:out_len]


def restrict_fast(tp: TransferPlan, v: torch.Tensor) -> torch.Tensor:
    """Pᵀ @ v on K1 over the members-ELL (a level sharded over ranks:
    ``parallel.RankTransfer``)."""
    if hasattr(tp, "mesh"):
        return tp.restrict(v)
    return gather.gather_spmv(tp.m_cols, tp.m_vals, v)[: tp.nc_pad]
