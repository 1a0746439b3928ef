"""Build the port's objects from plain numpy arrays.

This carries a setup or hierarchy made by another implementation (the JAX
package, through ``np.asarray`` of its arrays) into the port, so both can
run the same preconditioner: the same operators, labels and λmax values.
Nothing here imports or accepts anything but numpy arrays and Python
scalars.  The objects land on the card unless the caller asks for another
device.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from .setup.aggregation import SetupResult
from .solve.hierarchy import Hierarchy, build_hierarchy
from .sparse.formats import ELL

_DTYPES = {np.dtype(np.float32): torch.float32,
           np.dtype(np.float64): torch.float64}


def ell_from_numpy(cols: np.ndarray, vals: np.ndarray, rownnz: np.ndarray,
                   nrows: int, ncols: int,
                   device: torch.device | str = "cuda",
                   vals_t: np.ndarray | None = None) -> ELL:
    """An ELL from slot-major (K, npad) ``cols``/``vals`` and (npad,)
    ``rownnz``, and optionally the transposed-value field ``vals_t``
    (K, npad) of a union-pattern operator; the value dtype is kept."""
    vals = np.array(vals)           # copies: the inputs may be read-only
    if vals.dtype not in _DTYPES:
        raise ValueError(f"unsupported value dtype {vals.dtype}")
    if vals_t is not None:
        vals_t = np.array(vals_t)
        if vals_t.dtype != vals.dtype or vals_t.shape != vals.shape:
            raise ValueError(f"vals_t {vals_t.dtype} {vals_t.shape} does "
                             f"not match vals {vals.dtype} {vals.shape}")
        vals_t = torch.from_numpy(vals_t).to(device)
    return ELL(cols=torch.from_numpy(np.array(cols, np.int32)).to(device),
               vals=torch.from_numpy(vals).to(device),
               rownnz=torch.from_numpy(np.array(rownnz, np.int32)).to(device),
               nrows=int(nrows), ncols=int(ncols), vals_t=vals_t)


def setup_from_numpy(matrices: Sequence[dict],
                     level_labels: Sequence[np.ndarray],
                     device: torch.device | str = "cuda",
                     p_ops: Sequence[dict] | None = None,
                     pt_ops: Sequence[dict] | None = None,
                     smooth_omega: float | None = None) -> SetupResult:
    """A SetupResult from per-level operators, each a dict of
    ``ell_from_numpy``'s arguments (``cols``, ``vals``, ``rownnz``,
    ``nrows``, ``ncols``, optionally ``vals_t``), and the per-level label
    vectors; for a smoothed setup also the per-level P and Pᵀ, dicts of
    the same kind, and the ω they were smoothed with."""
    mats = [ell_from_numpy(**m, device=device) for m in matrices]
    labels = [torch.from_numpy(np.array(l, np.int32)).to(device)
              for l in level_labels]
    if (p_ops is None) != (pt_ops is None):
        raise ValueError("p_ops and pt_ops come together")

    def ells(ops):
        return None if ops is None else [ell_from_numpy(**m, device=device)
                                         for m in ops]
    return SetupResult(matrices=mats, level_labels=labels, p_ops=ells(p_ops),
                       pt_ops=ells(pt_ops),
                       smooth_omega=None if smooth_omega is None
                       else float(smooth_omega))


# the smoother state a hierarchy can carry over, per level
SMOOTHER_STATE = ("d", "lvals", "uvals", "udiag")


def hierarchy_from_numpy(matrices: Sequence[dict],
                         level_labels: Sequence[np.ndarray],
                         lmax_per_level: Sequence[float] | None = None,
                         smoother_state: Sequence[dict] | None = None,
                         device: torch.device | str = "cuda",
                         p_ops: Sequence[dict] | None = None,
                         pt_ops: Sequence[dict] | None = None,
                         **hierarchy_kw) -> Hierarchy:
    """A Hierarchy over the given setup.  ``lmax_per_level`` (safety
    factor included) replaces the power-iteration estimates when given.
    ``smoother_state``: per level, a dict of numpy arrays that replace the
    computed smoother state: the smoothing diagonal ``d`` (npad,), and for
    ``ilu0`` the factors ``lvals``, ``uvals`` (K, npad, on the level's slot
    pattern) and ``udiag`` (npad,).  The smoother's kind and parameters
    are ``build_hierarchy``'s keywords in ``hierarchy_kw``.  ``p_ops``/
    ``pt_ops``: a smoothed setup's P and Pᵀ per level (dicts of
    ``ell_from_numpy``'s arguments), its weighted transfers."""
    s = setup_from_numpy(matrices, level_labels, device=device, p_ops=p_ops,
                         pt_ops=pt_ops)
    lmax = None if lmax_per_level is None else [float(v)
                                                for v in lmax_per_level]
    state = None
    if smoother_state is not None:
        state = []
        for m, st in zip(s.matrices, smoother_state):
            unknown = set(st) - set(SMOOTHER_STATE)
            if unknown:
                raise ValueError(f"unknown smoother state {sorted(unknown)}; "
                                 f"one of {SMOOTHER_STATE}")
            lvl = {}
            for key, v in st.items():
                v = np.array(v)
                shape = (m.k, m.npad) if key in ("lvals", "uvals") \
                    else (m.npad,)
                if v.shape != shape or v.dtype not in _DTYPES \
                        or _DTYPES[v.dtype] != m.dtype:
                    raise ValueError(f"smoother state {key}: {v.dtype} "
                                     f"{v.shape}, the level needs {m.dtype} "
                                     f"{shape}")
                lvl[key] = torch.from_numpy(v).to(device)
            state.append(lvl)
    return build_hierarchy(s.matrices[0], s.level_labels, s.matrices[1:],
                           lmax=lmax, smoother_state=state, p_ops=s.p_ops,
                           pt_ops=s.pt_ops, **hierarchy_kw)
