"""Hybrid DIA + ELL operator — the SpMV format of the solve phase.

The benchmark matrices are stencils (5-point Poisson, 7-point skyscraper),
whose entries sit on a handful of constant diagonals j − i ∈ {o₁…o_D};
the Galerkin coarse operators keep most entries near a few diagonals too.
Entries on those diagonals need no gather: y += dval_d · shift(x, o_d),
contiguous loads.  The stragglers stay in an ELL remainder.  One launch
of the K1 kernel (``ops.gather.hyb_spmv``) computes both parts of an
SpMV.

The strictly lower and upper parts of a hybrid operator (the triangular
SpMVs of two-stage Gauss-Seidel) are hybrid operators of their own,
split once per level (:func:`triangular_part`), so that each triangular
SpMV is one K1 launch too.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field

import numpy as np
import torch

from ..ops import gather
from . import ops as ell_ops
from ..utils import timing
from .formats import ELL


@dataclass
class HYB:
    """``offsets``: diagonal shifts (tuple of ints, may be empty);
    ``dvals[d, i] = A[i, i + offsets[d]]`` (0 where absent or out of
    range); ``ell``: the remainder entries (None when everything fits on
    the diagonals); ``lanes``: the offsets packed once for K1."""

    dvals: torch.Tensor          # (D, npad) — D may be 0
    ell: ELL | None
    offsets: tuple
    nrows: int
    ncols: int
    lanes: gather.HybLanes = field(init=False, repr=False, compare=False)

    def __post_init__(self):
        self.lanes = gather.pack_lanes(self.offsets)

    @property
    def npad(self) -> int:
        return self.dvals.shape[1]

    @property
    def dtype(self) -> torch.dtype:
        return self.dvals.dtype

    @property
    def device(self) -> torch.device:
        return self.dvals.device


def _offsets_from_host_sample(sample_cols: np.ndarray,
                              sample_nnz: np.ndarray, rows: np.ndarray,
                              n: int, npad: int, max_diags: int,
                              min_fill: float) -> list[int]:
    """Offset detection from a strided row sample (host)."""
    k = sample_cols.shape[0]
    valid = (np.arange(k)[:, None] < sample_nnz[None, :]) & \
            (rows[None, :] < n)
    offs = sample_cols.astype(np.int64) - rows[None, :]
    vals, counts = np.unique(offs[valid], return_counts=True)
    nsample = max(int(valid.sum()), 1)
    frac = counts / nsample                # fraction of sampled nnz
    # an offset qualifies if its nnz share suggests ≥ min_fill·n entries
    avg_k = nsample / max(len(np.unique(rows[rows < n])), 1)
    keep = [int(o) for o, f in zip(vals, frac)
            if f * avg_k >= min_fill and abs(int(o)) < npad]
    keep = sorted(keep, key=lambda o: -frac[list(vals).index(o)])[:max_diags]
    return sorted(keep)


def hybrid_from_ell(a: ELL, max_diags: int = 48,
                    min_fill: float = 0.02) -> HYB:
    """DIA/ELL split of ``a``: offsets detected from every
    ``max(1, npad // 4096)``-th row, the split built on the device with
    masked reductions and one stable sort along the slot axis."""
    stride = max(1, a.npad // 4096)
    # the sampled columns and the sample's row counts in one read
    sample = timing.read(torch.cat([a.cols[:, ::stride],
                                    a.rownnz[None, ::stride]]), array=True)
    sample_cols, sample_nnz = sample[:-1], sample[-1]
    rows = np.arange(a.npad, dtype=np.int64)[::stride]
    offsets = _offsets_from_host_sample(sample_cols, sample_nnz, rows,
                                        a.nrows, a.npad, max_diags, min_fill)
    mask = a.slot_mask()
    slot_off = a.cols - a.row_iota()
    covered = torch.zeros_like(mask)
    dvals = []
    for o in offsets:
        hit = mask & (slot_off == o)
        dvals.append(torch.where(hit, a.vals, 0.0).sum(0))
        covered |= hit
    dvals = torch.stack(dvals) if offsets else \
        torch.zeros((0, a.npad), dtype=a.vals.dtype, device=a.device)
    # compact the remainder: non-covered valid slots first, in slot order
    keep = mask & ~covered
    key = (~keep).to(torch.int32)
    _, order = torch.sort(key, dim=0, stable=True)
    rcols = torch.gather(a.cols, 0, order)
    rvals = torch.gather(a.vals, 0, order)
    rnnz = keep.to(torch.int32).sum(0, dtype=torch.int32)
    k_rest = timing.read(rnnz.max()) if a.npad else 0
    ell = None
    if k_rest > 0:
        sl = torch.arange(k_rest, dtype=torch.int32, device=a.device)
        ok = sl[:, None] < rnnz[None, :]
        ell = ELL(cols=torch.where(ok, rcols[:k_rest], 0).contiguous(),
                  vals=torch.where(ok, rvals[:k_rest], 0.0).contiguous(),
                  rownnz=rnnz, nrows=a.nrows, ncols=a.ncols)
    return HYB(dvals=dvals, ell=ell, offsets=tuple(offsets), nrows=a.nrows,
               ncols=a.ncols)


def spmv(a: HYB, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x for an ``(npad,)`` vector ``x``, one K1 launch.  Diagonal
    ``o`` adds dval · x[i + o] over the rows whose column i + o lies in
    [0, npad): the elementwise arithmetic of the reference's
    y + dval · roll(x, −o), whose wrapped positions carry dval = 0 (the
    splitter stores in-range entries only), without the rolled copy."""
    e = a.ell
    return gather.hyb_spmv(a.dvals, a.lanes, None if e is None else e.cols,
                           None if e is None else e.vals, x.contiguous())


def _tri_mask(e: ELL, lower: bool) -> torch.Tensor:
    """The remainder slots of the strictly lower (upper) part: stored
    values with ``col < row`` (``col > row``), as the JAX package masks
    them (its remainder's invalid slots hold val 0)."""
    ri = e.row_iota()
    return (e.vals != 0.0) & ((e.cols < ri) if lower else (e.cols > ri))


def triangular_part(a: HYB, lower: bool) -> HYB:
    """The strictly lower (``lower``) or strictly upper part of ``a`` as a
    hybrid operator: the lanes with offset < 0 (> 0), and the remainder
    with its values kept only on the triangle (the slot pattern is
    unchanged).  Built once per level; its SpMV is one K1 launch."""
    keep = [d for d, o in enumerate(a.offsets) if (o < 0 if lower else o > 0)]
    ell = None
    if a.ell is not None:
        e = a.ell
        ell = dataclasses.replace(
            e, vals=torch.where(_tri_mask(e, lower), e.vals, 0.0).contiguous(),
            vals_t=None)
    return HYB(dvals=a.dvals[keep].contiguous(), ell=ell,
               offsets=tuple(a.offsets[d] for d in keep), nrows=a.nrows,
               ncols=a.ncols)


def spmv_tri(a: HYB, x: torch.Tensor, lower: bool) -> torch.Tensor:
    """Plain torch strictly lower (or upper) SpMV of ``a`` in the JAX
    package's form: the lanes of one sign of offset one by one, then the
    remainder masked to the triangle, gathered and summed over the slots.
    :func:`triangular_part`'s one K1 launch computes the same product."""
    n = a.npad
    y = torch.zeros((n,), dtype=x.dtype, device=x.device)
    for d, o in enumerate(a.offsets):
        if (o < 0) if lower else (o > 0):
            lo, hi = max(0, -o), min(n, n - o)
            y[lo:hi] += a.dvals[d, lo:hi] * x[lo + o:hi + o]
    if a.ell is not None:
        e = a.ell
        g = x[e.cols.long()]
        y = y + (torch.where(_tri_mask(e, lower), e.vals, 0.0) * g).sum(0)
    return y


def extract_diag(a: HYB) -> torch.Tensor:
    d = torch.zeros((a.npad,), dtype=a.dtype, device=a.device)
    for i, o in enumerate(a.offsets):
        if o == 0:
            d = d + a.dvals[i]
    if a.ell is not None:
        d = d + ell_ops.extract_diag(a.ell)[: a.npad]
    return d


def row_sum_abs_offdiag(a: HYB) -> torch.Tensor:
    """Σⱼ≠ᵢ |aᵢⱼ| per row (the l1-Jacobi safeguard)."""
    s = torch.zeros((a.npad,), dtype=a.dtype, device=a.device)
    for i, o in enumerate(a.offsets):
        if o != 0:
            s = s + a.dvals[i].abs()
    if a.ell is not None:
        s = s + ell_ops.row_sum(a.ell, absolute=True,
                                skip_diag=True)[: a.npad]
    return s


def row_mask(a: HYB) -> torch.Tensor:
    ri = torch.arange(a.npad, dtype=torch.int32, device=a.device)
    return ri < a.nrows
