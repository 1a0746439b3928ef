"""A plain ILU(0) reference in PyTorch: nothing here imports JAX or the
program, and every function takes a matrix as its CSR arrays.

* :func:`ikj_ilu0` is the sequential IKJ ILU(0) (Saad, Iterative Methods,
  Alg. 10.4), entry by entry in Python floats (float64): for small
  matrices.
* :func:`chow_patel` is the fine-grained parallel ILU(0) of Chow and
  Patel (2015): every stored entry's fixed-point equation updated at once
  from the previous iterate, sweep after sweep, from l_ij = a_ij / a_jj
  and u_ij = a_ij.  Its triples (i, k, j), one a product l_ik u_kj, are
  listed once, in blocks of ``block`` lower entries, so that a matrix of
  10⁶-10⁷ rows fits.
* :func:`neumann_apply` is the smoothing x ← x + (LU)⁻¹(b − A x) with
  both triangular solves replaced by ``inner`` truncated Neumann terms;
  :func:`exact_apply` solves them exactly (dense: for small matrices).

Factors are returned on A's pattern as one value per stored entry:
L's strictly lower values (unit diagonal implicit) where col < row, U's
values where col ≥ row.  The benchmark and the tests each keep a copy of
this file, so that a change to one does not move what the other holds.
"""
from __future__ import annotations

import torch


def csr_arrays(m, device="cpu", dtype=torch.float64):
    """(indptr, indices, values) of a scipy CSR with sorted indices, as
    int64 and ``dtype`` tensors."""
    return (torch.as_tensor(m.indptr, dtype=torch.int64, device=device),
            torch.as_tensor(m.indices, dtype=torch.int64, device=device),
            torch.as_tensor(m.data, dtype=dtype, device=device))


def entry_rows(indptr: torch.Tensor) -> torch.Tensor:
    """The row of every stored entry."""
    n = indptr.numel() - 1
    return torch.repeat_interleave(torch.arange(n, device=indptr.device),
                                   indptr.diff())


def spmv(indptr, indices, vals, x):
    """y = A x in ``vals``' precision."""
    y = torch.zeros(indptr.numel() - 1, dtype=vals.dtype, device=vals.device)
    return y.index_add_(0, entry_rows(indptr), vals * x[indices].to(vals.dtype))


def diagonal(indptr, indices, vals):
    """A's diagonal (0 where it is not stored)."""
    rows = entry_rows(indptr)
    d = torch.zeros(indptr.numel() - 1, dtype=vals.dtype, device=vals.device)
    on = indices == rows
    return d.index_put_((rows[on],), vals[on])


def ikj_ilu0(indptr, indices, vals) -> torch.Tensor:
    """Sequential IKJ ILU(0) in float64: for each row i and each stored
    k < i in order, l_ik = a_ik / u_kk, then a_ij −= l_ik u_kj for every
    stored j > k of row i with (k, j) stored."""
    ptr = indptr.tolist()
    col = indices.tolist()
    f = vals.double().tolist()
    n = len(ptr) - 1
    pos = [{col[p]: p for p in range(ptr[i], ptr[i + 1])} for i in range(n)]
    for i in range(n):
        for p in range(ptr[i], ptr[i + 1]):
            k = col[p]
            if k >= i:
                break
            f[p] /= f[pos[k][k]]
            for q in range(p + 1, ptr[i + 1]):
                kj = pos[k].get(col[q])
                if kj is not None:
                    f[q] -= f[p] * f[kj]
    return torch.tensor(f, dtype=torch.float64, device=vals.device)


def triples(indptr, indices, block: int = 1 << 22):
    """Every product of the fixed-point sums as three entry positions
    (e: l_ik, f: u_kj, t: the target (i, j)): l_ik from a strictly lower
    entry of row i, u_kj from a strictly upper entry of row k, (i, j)
    stored (then k < min(i, j)).  Indices must be sorted within rows."""
    n = indptr.numel() - 1
    dev = indices.device
    rows = entry_rows(indptr)
    keys = rows * n + indices
    lower = torch.nonzero(indices < rows).flatten()
    upper_start = torch.searchsorted(
        keys, torch.arange(n, device=dev) * (n + 1), right=True)
    out = []
    for c in range(0, lower.numel(), block):
        e = lower[c:c + block]
        k = indices[e]
        lo, hi = upper_start[k], indptr[k + 1]
        e = torch.repeat_interleave(e, hi - lo)
        start = torch.repeat_interleave(lo, hi - lo)
        first = torch.cumsum(hi - lo, 0) - (hi - lo)
        f = start + torch.arange(e.numel(), device=dev) \
            - torch.repeat_interleave(first, hi - lo)
        want = rows[e] * n + indices[f]
        t = torch.searchsorted(keys, want).clamp_max(keys.numel() - 1)
        hit = keys[t] == want
        out.append((e[hit], f[hit], t[hit]))
    return tuple(torch.cat(parts) for parts in zip(*out))


def chow_patel(indptr, indices, vals, sweeps: int,
               dtype: torch.dtype = torch.float64, block: int = 1 << 22,
               trip=None) -> torch.Tensor:
    """``sweeps`` synchronous Chow–Patel sweeps in ``dtype``:

        l_ij = (a_ij − Σ_{k<j} l_ik u_kj) / u_jj      (i > j)
        u_ij =  a_ij − Σ_{k<i} l_ik u_kj              (i ≤ j)

    every value from the previous iterate (u_jj too; a zero u_jj or a_jj
    counts as 1).  ``trip``: :func:`triples` of the pattern, when already
    listed."""
    rows = entry_rows(indptr)
    e, f, t = trip if trip is not None else triples(indptr, indices, block)
    a = vals.to(dtype)
    low = indices < rows
    on = indices == rows
    n = indptr.numel() - 1

    def udiag(w):
        d = torch.zeros(n, dtype=dtype, device=a.device)
        d = d.index_put_((rows[on],), w[on])
        return torch.where(d != 0, d, torch.ones_like(d))

    w = torch.where(low, a / udiag(a)[indices], a)
    for _ in range(sweeps):
        s = torch.zeros_like(a).index_add_(0, t, w[e] * w[f])
        new = a - s
        w = torch.where(low, new / udiag(w)[indices], new)
    return w


def split(indptr, indices, w):
    """(L's strictly lower values, U's strictly upper values, U's
    diagonal) of factors on the pattern, each zero elsewhere."""
    rows = entry_rows(indptr)
    zero = torch.zeros_like(w)
    d = diagonal(indptr, indices, w)
    return (torch.where(indices < rows, w, zero),
            torch.where(indices > rows, w, zero),
            torch.where(d != 0, d, torch.ones_like(d)))


def neumann_apply(indptr, indices, avals, w, b, x, sweeps: int,
                  inner: int) -> torch.Tensor:
    """x ← x + M⁻¹(b − A x), ``sweeps`` times, M = L U from factors ``w``
    on the pattern, each triangular solve ``inner`` truncated Neumann
    terms: z ← r − L z, then y ← D⁻¹(z − U' y) with D = diag(U)."""
    lv, uv, d = split(indptr, indices, w)
    for _ in range(sweeps):
        r = b - spmv(indptr, indices, avals, x)
        z = r
        for _ in range(inner):
            z = r - spmv(indptr, indices, lv, z)
        y = z / d
        for _ in range(inner):
            y = (z - spmv(indptr, indices, uv, y)) / d
        x = x + y
    return x


def dense_factors(indptr, indices, w):
    """L (unit diagonal) and U as dense matrices."""
    n = indptr.numel() - 1
    rows = entry_rows(indptr)
    lv, uv, d = split(indptr, indices, w)
    lo = torch.eye(n, dtype=w.dtype, device=w.device)
    lo[rows, indices] += lv
    up = torch.diag(d)
    up[rows, indices] += uv
    return lo, up


def exact_apply(indptr, indices, avals, w, b, x,
                sweeps: int) -> torch.Tensor:
    """:func:`neumann_apply` with exact triangular solves."""
    lo, up = dense_factors(indptr, indices, w)
    for _ in range(sweeps):
        r = (b - spmv(indptr, indices, avals, x))[:, None]
        z = torch.linalg.solve_triangular(lo, r, upper=False,
                                          unitriangular=True)
        x = x + torch.linalg.solve_triangular(up, z, upper=True)[:, 0]
    return x
