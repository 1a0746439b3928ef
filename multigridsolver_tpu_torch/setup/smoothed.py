"""Smoothed-aggregation prolongation.

The tentative prolongation P₀ of an aggregation (one unit entry per
aggregated row) damped by one weighted-Jacobi step,

    P_s = (I − ω D⁻¹ A) · P₀ ,

and the Galerkin product with such a P, Ac = Pᵀ A P, by two SpGEMMs.
Rows of excluded nodes stay empty in P_s, so they receive no coarse
correction, as in the unsmoothed scheme.
"""
from __future__ import annotations

import dataclasses

import torch

from ..sparse import ops
from ..sparse.formats import ELL
from ..sparse.spgemm import spgemm_ell, transpose_ell


def tentative_p(labels: torch.Tensor, nrows: int, nc: int,
                dtype: torch.dtype = torch.float32) -> ELL:
    """P₀ as a K = 1 ELL over the fine rows: unit entries, empty rows for
    excluded nodes."""
    valid = labels >= 0
    return ELL(cols=torch.where(valid, labels, 0).to(torch.int32)[None, :],
               vals=valid.to(dtype)[None, :],
               rownnz=valid.to(torch.int32), nrows=nrows, ncols=nc)


def jacobi_operator(a: ELL, omega: float) -> ELL:
    """M = I − ω D⁻¹ A on A's pattern (A stores its diagonal), in the JAX
    package's operation order: vals · (−ω / d) + [diagonal]."""
    d = ops.extract_diag(a)
    d_safe = torch.where(d == 0.0, 1.0, d)
    scale = (torch.full_like(d_safe, -omega) / d_safe)[None, :]
    isdiag = (a.cols == a.row_iota()) & a.slot_mask()
    mvals = a.vals * scale + torch.where(isdiag, 1.0, 0.0).to(a.vals.dtype)
    return dataclasses.replace(a, vals=mvals, vals_t=None)


def smoothed_prolongation(a: ELL, labels: torch.Tensor, nc: int,
                          omega: float = 2.0 / 3.0) -> ELL:
    """P_s = (I − ω D⁻¹ A) P₀ as an (n × nc) ELL."""
    ps = spgemm_ell(jacobi_operator(a, omega),
                    tentative_p(labels, a.nrows, nc, a.vals.dtype))
    valid = labels >= 0
    return dataclasses.replace(
        ps, vals=torch.where(valid[None, :], ps.vals, 0.0),
        cols=torch.where(valid[None, :], ps.cols, 0),
        rownnz=torch.where(valid, ps.rownnz, 0))


def galerkin_general(a: ELL, p: ELL) -> tuple[ELL, ELL]:
    """(Ac, Pᵀ) with Ac = Pᵀ (A P), two SpGEMMs."""
    pt = transpose_ell(p)
    return spgemm_ell(pt, spgemm_ell(a, p)), pt
