"""The plain reference that decides ``correct``.

Plain numpy, scipy and torch: nothing here imports the program, and
nothing takes what the program made but the outputs it judges (a
solution x, a setup's labels and coarse operators).  Every input comes
from the benchmark's own generators and request stream.

* :func:`poisson_solve` solves the 5-point Laplacian exactly by its
  eigenvectors (the 2D sine transform, as four dense products with the
  sine matrix), in float64 as the reference and in a lower precision as
  the control.
* :func:`true_residual` is ‖b − A x‖ / ‖b‖ in float64.
* :func:`galerkin_chain` works out every coarse operator again as
  Pᵀ A P from the labels, level after level from its own operators.
* :func:`aggregation_faults` counts where labels fail to form an
  aggregation: a label out of range, an empty aggregate, or one with more
  members than the passes can pair.
"""
from __future__ import annotations

import math

import numpy as np
import torch


def sine_matrix(n: int, dtype: torch.dtype, device) -> torch.Tensor:
    """The orthonormal DST-I matrix, symmetric with S·S = I."""
    k = torch.arange(1, n + 1, dtype=torch.float64, device=device)
    s = math.sqrt(2.0 / (n + 1)) * torch.sin(
        math.pi * k[:, None] * k[None, :] / (n + 1))
    return s.to(dtype)


def poisson_solve(b: torch.Tensor, n: int,
                  dtype: torch.dtype = torch.float64) -> torch.Tensor:
    """x with A x = b for A = poisson2d(n) (row index i·n + j), computed
    in ``dtype``: A = T⊗I + I⊗T with T = tridiag(−1, 2, −1) = S Λ S, so
    X = S ((S B S) / (λᵢ + λⱼ)) S.  Returns a flat float64 tensor."""
    s = sine_matrix(n, dtype, b.device)
    k = torch.arange(1, n + 1, dtype=torch.float64, device=b.device)
    lam = 2.0 - 2.0 * torch.cos(math.pi * k / (n + 1))
    denom = (lam[:, None] + lam[None, :]).to(dtype)
    bm = b.reshape(n, n).to(dtype)
    xm = s @ ((s @ bm @ s) / denom) @ s
    return xm.reshape(-1).double()


def forward_error(x: torch.Tensor, x_ref: torch.Tensor) -> float:
    """max |x − x_ref| / max |x_ref|, in float64."""
    x_ref = x_ref.double()
    return float((x.double().to(x_ref.device) - x_ref).abs().max()
                 / x_ref.abs().max())


def true_residual(a, b: np.ndarray, x: np.ndarray) -> float:
    """‖b − A x‖₂ / ‖b‖₂ in float64 for a scipy matrix ``a``."""
    b = np.asarray(b, dtype=np.float64)
    x = np.asarray(x, dtype=np.float64)
    return float(np.linalg.norm(b - a @ x) / np.linalg.norm(b))


def coo_of_scipy(a, device, dtype=torch.float64):
    """(keys row·ncols + col, values) of a scipy matrix, keys sorted."""
    c = a.tocoo()
    rows = torch.from_numpy(c.row.astype(np.int64)).to(device)
    cols = torch.from_numpy(c.col.astype(np.int64)).to(device)
    vals = torch.from_numpy(c.data.astype(np.float64)).to(device)
    return _merge(rows * a.shape[1] + cols, vals.to(dtype))


def _merge(keys: torch.Tensor, vals: torch.Tensor):
    """Sorted unique keys and their summed values."""
    uk, inv = torch.unique(keys, sorted=True, return_inverse=True)
    out = torch.zeros(uk.shape, dtype=vals.dtype, device=vals.device)
    out.index_add_(0, inv, vals)
    return uk, out


def galerkin(keys: torch.Tensor, vals: torch.Tensor, ncols: int,
             labels: torch.Tensor, nc: int):
    """Pᵀ A P for P[i, labels[i]] = 1 (no column for label −1): each
    entry a_ij lands on (labels[i], labels[j]), summed in ``vals``'s
    dtype.  ``keys``/``vals`` as :func:`coo_of_scipy` gives them."""
    rows, cols = keys // ncols, keys % ncols
    li, lj = labels[rows], labels[cols]
    keep = (li >= 0) & (lj >= 0)
    return _merge(li[keep] * nc + lj[keep], vals[keep])


def galerkin_chain(keys: torch.Tensor, vals: torch.Tensor, ncols: int,
                   s: float, labels: list[torch.Tensor],
                   dtype: torch.dtype = torch.float64):
    """The coarse operators of every level, worked out again in
    ``dtype`` from the matrix (``keys``/``vals`` as
    :func:`coo_of_scipy` gives them, ``ncols`` columns) scaled by ``s``
    and each level's labels (logical rows, int64), each level from the
    one before it as this chain computed it.  Returns [(keys, vals, nc),
    ...], the first coarse level first."""
    vals = (vals * s).to(dtype)
    out = []
    for lab in labels:
        nc = int(lab.max()) + 1 if lab.numel() else 0
        keys, vals = galerkin(keys, vals, ncols, lab, nc)
        out.append((keys, vals, nc))
        ncols = nc
    return out


def operator_error(keys: torch.Tensor, vals: torch.Tensor,
                   ref_keys: torch.Tensor, ref_vals: torch.Tensor) -> float:
    """max |A − A_ref| / max |A_ref| over the union of both patterns (an
    entry one side lacks counts as 0 there), in float64."""
    allk = torch.cat([keys, ref_keys])
    allv = torch.cat([vals.double(), -ref_vals.double()])
    _, diff = _merge(allk, allv)
    scale = ref_vals.double().abs().max()
    return float(diff.abs().max() / scale)


def aggregation_faults(labels: torch.Tensor, nc: int, max_size: int) -> int:
    """How many ways ``labels`` (a level's logical rows) fail to form an
    aggregation into ``nc`` coarse nodes: labels below −1 or at or past
    ``nc``, empty aggregates, and aggregates of more than ``max_size``
    members."""
    bad = int(((labels < -1) | (labels >= nc)).sum())
    members = labels[(labels >= 0) & (labels < nc)]
    counts = torch.bincount(members, minlength=nc)[:nc]
    return bad + int((counts == 0).sum()) + int((counts > max_size).sum())
