"""General sparse × sparse product and transpose on slot-major ELLs.

SpGEMM is a merge accumulator: for each slot k of A, B's whole rows at
j = A.cols[k] are fetched (K3: columns, values and row lengths in one
launch), scaled by A.vals[k] and merged into a running per-row
accumulator of width ``kc`` (sort by column, add the run, compact).
Each merge sees a column at most twice, once in the accumulator and once
in B's row, so every output value is a fold over A's slots in slot
order, as in the JAX package.  The width protocol is the JAX package's:
a first guess of ``kc``, one host read of the largest row degree per
attempt, growth to it on overflow; the output's slot width decides the
order of later slot sums, so it must equal the JAX package's.

The transpose lists every source column's entries by ascending source
row (CSR-canonical), from one stable sort.
"""
from __future__ import annotations

import torch

from . import ops
from ..utils import timing
from .formats import ELL, _round_up


def _merge_rows(cand_c: torch.Tensor, cand_v: torch.Tensor, sentinel: int,
                kc: int):
    """Per-row merge of (W, n) candidates (invalid: col ``sentinel``, val
    0): sort by column, add runs (of at most two), keep the first ``kc``
    distinct columns.  Returns (cols (kc, n) with ``sentinel`` past each
    row's length, vals, max row length before clipping)."""
    cand_c, order = torch.sort(cand_c, dim=0, stable=True)
    cand_v = torch.gather(cand_v, 0, order)
    w, n = cand_c.shape
    dev = cand_c.device
    # a run's total sits at its last element
    same_prev = torch.zeros_like(cand_c, dtype=torch.bool)
    same_prev[1:] = cand_c[1:] == cand_c[:-1]
    prev_v = torch.zeros_like(cand_v)
    prev_v[1:] = cand_v[:-1]
    merged = torch.where(same_prev, prev_v + cand_v, cand_v)
    last = torch.ones_like(same_prev)
    last[:-1] = ~same_prev[1:]
    keep = last & (cand_c < sentinel)
    pos = torch.cumsum(keep.to(torch.int32), 0, dtype=torch.int32) - 1
    rownnz = pos[-1] + 1
    ok = keep & (pos < kc)
    at = torch.where(ok, pos, kc).long()
    out_c = torch.full((kc + 1, n), sentinel, dtype=torch.int32, device=dev)
    out_v = torch.zeros((kc + 1, n), dtype=cand_v.dtype, device=dev)
    out_c.scatter_(0, at, torch.where(ok, cand_c, sentinel))
    out_v.scatter_(0, at, torch.where(ok, merged, 0.0))
    return out_c[:kc], out_v[:kc], rownnz.max()


def spgemm_arrays(a: ELL, b: ELL, kc: int):
    """C = A·B at slot width ``kc``: (cols, vals, rownnz, max_deg), the
    entries past ``kc`` dropped (max_deg, a device scalar, tells)."""
    sentinel = b.npad
    dev = a.device
    acc_c = torch.full((kc, a.npad), sentinel, dtype=torch.int32,
                       device=dev)
    acc_v = torch.zeros((kc, a.npad), dtype=a.vals.dtype, device=dev)
    max_deg = torch.zeros((), dtype=torch.int32, device=dev)
    slot_b = torch.arange(b.k, dtype=torch.int32, device=dev)[:, None]
    sources = [b.cols, b.vals, b.rownnz[None, :]]
    for ka in range(a.k):
        av = a.vals[ka]
        valid_a = (ka < a.rownnz) & (av != 0.0)
        cols_b, vals_b, nnz_b = ops.take_member_rows_many(a.cols[ka],
                                                          sources)
        ok = valid_a[None, :] & (slot_b < nnz_b)
        cand_c = torch.cat([acc_c, torch.where(ok, cols_b, sentinel)])
        cand_v = torch.cat([acc_v, torch.where(
            ok, av[None, :] * vals_b.to(a.vals.dtype), 0.0)])
        acc_c, acc_v, md = _merge_rows(cand_c, cand_v, sentinel, kc)
        max_deg = torch.maximum(max_deg, md)
    valid = acc_c < sentinel
    return (torch.where(valid, acc_c, 0), torch.where(valid, acc_v, 0.0),
            valid.sum(0, dtype=torch.int32), max_deg)


def spgemm_ell(a: ELL, b: ELL, kc: int | None = None) -> ELL:
    """C = A·B as an ELL, its slot width the largest row degree (one host
    read per attempt, growing ``kc`` on overflow)."""
    if a.ncols > b.nrows:
        raise ValueError(f"shape mismatch: {a.ncols} vs {b.nrows}")
    if kc is None:
        kc = min(a.k * b.k, max(2 * (a.k + b.k), 16), max(b.ncols, 1))
    while True:
        cols, vals, rownnz, max_deg = spgemm_arrays(a, b, kc)
        md = int(max_deg)
        if md <= kc:
            break
        kc = md
    kc_eff = max(min(md, kc), 1)
    return ELL(cols=cols[:kc_eff].contiguous(),
               vals=vals[:kc_eff].contiguous(), rownnz=rownnz,
               nrows=a.nrows, ncols=b.ncols)


def transpose_ell(a: ELL, kt: int | None = None) -> ELL:
    """Aᵀ as an ELL with rows padded to a multiple of 1024; row j lists
    the source rows storing column j in ascending order.  ``kt`` bounds
    its width (read back once when None)."""
    dev = a.device
    npad_t = _round_up(max(a.ncols, 1), 1024)
    mask = a.slot_mask()
    # entries in row-major order, so a stable sort by column keeps the
    # source rows ascending within each column
    col = torch.where(mask, a.cols, npad_t).T.reshape(-1).long()
    row = a.row_iota().T.reshape(-1)
    val = a.vals.T.reshape(-1)
    counts = ops.bin_counts(col, npad_t + 1)[:npad_t]
    if kt is None:
        kt = timing.read(counts.max())
    kt = max(int(kt), 1)
    col, order = torch.sort(col, stable=True)
    start = torch.cumsum(counts, 0) - counts
    slot = torch.arange(col.shape[0], device=dev) - start[
        col.clamp_max(npad_t - 1)]
    ok = (col < npad_t) & (slot < kt)
    flat = torch.where(ok, slot * npad_t + col, kt * npad_t)
    cols_t = torch.zeros((kt * npad_t + 1,), dtype=torch.int32, device=dev)
    vals_t = torch.zeros((kt * npad_t + 1,), dtype=a.vals.dtype, device=dev)
    cols_t.scatter_(0, flat, torch.where(ok, row[order], 0))
    vals_t.scatter_(0, flat, torch.where(ok, val[order], 0.0))
    return ELL(cols=cols_t[:-1].view(kt, npad_t),
               vals=vals_t[:-1].view(kt, npad_t),
               rownnz=counts.to(torch.int32),
               nrows=a.ncols, ncols=a.nrows)
