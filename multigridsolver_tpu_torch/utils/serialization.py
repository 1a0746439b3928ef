"""Hierarchy checkpoint and resume.

The reference's only persistence is the promatrix file, its setup/solve
boundary.  A :class:`~..solve.hierarchy.Hierarchy` (per-level operators,
labels, smoother state, weighted transfers, the coarse LU) is saved whole
to one ``.npz``: a ``manifest`` (JSON of the static metadata) and arrays
``leaf_0``, ``leaf_1``, … in the JAX package's layout, so a checkpoint
written by either implementation loads in the other.  Per level, in order:

* the operator, a DIA+ELL hybrid: ``dvals``, then the remainder's
  ``cols``, ``vals``, ``rownnz`` when it has one;
* ``labels``;
* the smoother: ``d``, ``lmax``, and for ``ilu0`` the strictly lower and
  upper factors on the level's slot pattern (``cols``, ``vals``,
  ``rownnz`` each) and U's diagonal;
* a weighted (smoothed) transfer plan's ``p_cols``, ``p_vals``,
  ``m_cols``, ``m_vals``; a label-derived plan is not stored and is
  rebuilt from the labels at load;

then the coarsest operator's ``cols``, ``vals``, ``rownnz``, its LU and
pivots.  Pivots are stored 0-based (scipy's and the JAX package's
convention); ``torch.linalg.lu_factor``'s are 1-based (LAPACK's), so they
are converted on save and on load.  Derived state (gs2's triangular
parts, the hybrid's packed lanes) is rebuilt at load.
"""
from __future__ import annotations

import json

import numpy as np
import torch

from ..setup import transfers as tf
from ..solve.hierarchy import CoarseSolve, Hierarchy, Level
from ..solve.smoothers import Smoother, split_triangular
from ..sparse.formats import ELL
from ..sparse.hybrid import HYB, hybrid_from_ell

_FORMAT_VERSION = 1


def _ell_leaves(e: ELL) -> list:
    return [e.cols, e.vals, e.rownnz]


def save_hierarchy(path: str, hier: Hierarchy) -> None:
    """Write ``hier`` to ``path`` (``.npz``, compressed)."""
    leaves: list[torch.Tensor] = []
    levels = []
    for lvl in hier.levels:
        a, sm, tp = lvl.a, lvl.smoother, lvl.tplan
        if not isinstance(a, HYB):
            raise ValueError("a row-sharded hierarchy is saved before "
                             "shard_hierarchy: save the unsharded one")
        leaves.append(a.dvals)
        if a.ell is not None:
            leaves += _ell_leaves(a.ell)
        leaves += [lvl.labels, sm.d, sm.lmax]
        if sm.lmat is not None:
            leaves += _ell_leaves(sm.lmat) + _ell_leaves(sm.umat)
            leaves.append(sm.udiag)
        if tp.weighted:
            leaves += [tp.p_cols, tp.p_vals, tp.m_cols, tp.m_vals]
        levels.append({
            "nrows": a.nrows, "ncols": a.ncols, "nc_pad": lvl.nc_pad,
            "is_hybrid": True, "tplan_weighted": bool(tp.weighted),
            "tplan_m_ov": False,
            "tplan_npad_f": tp.npad_f if tp.weighted else 0,
            "offsets": [int(o) for o in a.offsets],
            "has_rest": a.ell is not None,
            "has_ilu": sm.lmat is not None,
            "smoother": {"kind": sm.kind, "sweeps": sm.sweeps,
                         "omega": sm.omega, "degree": sm.degree,
                         "lmin_frac": sm.lmin_frac,
                         "inner_sweeps": sm.inner_sweeps}})
    c = hier.coarse
    leaves += _ell_leaves(c.a) + [c.lu, c.piv - 1]
    meta = {
        "version": _FORMAT_VERSION, "nlevels": hier.nlevels,
        "cycle": hier.cycle, "pre_smooth": hier.pre_smooth,
        "post_smooth": hier.post_smooth,
        "kcycle_steps": hier.kcycle_steps,
        "kcycle_depth": hier.kcycle_depth,
        "combination": hier.combination, "levels": levels,
        "coarse": {"nrows": c.a.nrows, "ncols": c.a.ncols}}
    arrays = {f"leaf_{i}": leaf.detach().cpu().numpy()
              for i, leaf in enumerate(leaves)}
    np.savez_compressed(path, manifest=json.dumps(meta), **arrays)


def load_hierarchy(path: str, dtype: torch.dtype | None = None,
                   device: torch.device | str = "cuda") -> Hierarchy:
    """Read a checkpoint onto ``device`` (the card unless the caller asks
    for another).  ``dtype``: cast every floating-point array to it (None
    keeps the stored one)."""
    with np.load(path, allow_pickle=False) as data:
        meta = json.loads(str(data["manifest"]))
        if meta["version"] != _FORMAT_VERSION:
            raise ValueError(f"unsupported checkpoint version "
                             f"{meta['version']}")
        arrays = [data[f"leaf_{i}"] for i in range(len(data.files) - 1)]

    def tensor(arr: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(np.array(arr)).to(device)
        return t.to(dtype) if dtype is not None and t.is_floating_point() \
            else t

    it = iter(arrays)

    def take(k: int) -> list[torch.Tensor]:
        out = [tensor(arr) for _, arr in zip(range(k), it)]
        if len(out) < k:
            raise ValueError(f"{path}: fewer arrays than its manifest "
                             "describes")
        return out

    def ell(nrows: int, ncols: int) -> ELL:
        cols, vals, rownnz = take(3)
        return ELL(cols=cols.to(torch.int32), vals=vals,
                   rownnz=rownnz.to(torch.int32), nrows=nrows, ncols=ncols)

    levels = []
    for lm in meta["levels"]:
        n, m = lm["nrows"], lm["ncols"]
        if lm["is_hybrid"]:
            (dvals,) = take(1)
            rest = ell(n, m) if lm["has_rest"] else None
            a = HYB(dvals=dvals, ell=rest, offsets=tuple(lm["offsets"]),
                    nrows=n, ncols=m)
        else:
            a = hybrid_from_ell(ell(n, m))
        (labels,) = take(1)
        labels = labels.to(torch.int32)
        d, lmax = take(2)
        sm = Smoother(d=d, lmax=lmax, **lm["smoother"])
        if lm["has_ilu"]:
            sm.lmat, sm.umat = ell(n, m), ell(n, m)
            (sm.udiag,) = take(1)
        if sm.kind == "gs2":
            sm.lower, sm.upper = split_triangular(a)
        if lm["tplan_weighted"]:
            if lm["tplan_m_ov"]:
                raise ValueError("a weighted transfer plan with split "
                                 "restriction overflow is not supported")
            p_cols, p_vals, m_cols, m_vals = take(4)
            tplan = tf.TransferPlan(
                p_cols=p_cols.to(torch.int32), p_vals=p_vals,
                m_cols=m_cols.to(torch.int32), m_vals=m_vals,
                npad_f=lm["tplan_npad_f"], nc_pad=lm["nc_pad"],
                weighted=True)
        else:
            tplan = tf.build_transfer_plan(labels, lm["nc_pad"], a.dtype)
        levels.append(Level(a=a, labels=labels, smoother=sm, tplan=tplan,
                            nc_pad=lm["nc_pad"]))
    ca = ell(meta["coarse"]["nrows"], meta["coarse"]["ncols"])
    lu, piv = take(2)
    if next(it, None) is not None:
        raise ValueError(f"{path}: more arrays than its manifest describes")
    coarse = CoarseSolve(a=ca, lu=lu, piv=(piv + 1).to(torch.int32),
                         m=int(lu.shape[0]))
    return Hierarchy(levels=tuple(levels), coarse=coarse,
                     cycle=meta["cycle"], pre_smooth=meta["pre_smooth"],
                     post_smooth=meta["post_smooth"],
                     kcycle_steps=meta["kcycle_steps"],
                     kcycle_depth=meta["kcycle_depth"],
                     combination=meta.get("combination", "multiplicative"))
