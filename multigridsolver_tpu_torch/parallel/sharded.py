"""Row-partitioned levels over a row mesh.

The scaling axis is matrix-row partitioning: a level of ``npad`` rows is
split into ``ndev`` shards of ``npr = npad / ndev`` consecutive rows, and
level vectors are split the same way.  :class:`RowMesh` is the
counterpart of the JAX package's one-axis ``Mesh``: it names the shards
and owns the collectives the sharded path uses (non-cyclic shifts of
boundary slabs into a halo, ``all_to_all``, ``all_gather``).

All shards of a mesh lie on one device, as the JAX package's
single-process mesh of virtual CPU devices does: a sharded array is the
whole array on that device, shard ``s`` its rows ``[s·npr, (s+1)·npr)``,
and each collective is a device-local copy with the collective's
semantics.  The shard boundaries, halos, exchange plans and per-shard
kernel launches are those of a mesh over several cards; only the bodies
of the collectives would change there (NCCL).

Only the finest levels are worth sharding; deeper levels and the dense
coarse LU stay as they are.
"""
from __future__ import annotations

import dataclasses

import torch

from ..ops import gather
from ..setup import transfers as tf
from ..solve.hierarchy import Hierarchy
from ..sparse.formats import ELL
from ..sparse.hybrid import HYB


class RowMesh:
    """``ndev`` row shards on one ``device``.

    The collectives take per-shard blocks stacked on a leading axis of
    length ``ndev`` (``send[s]`` is what shard ``s`` contributes) and
    return what each shard receives, stacked the same way.  A mesh over
    more than one distinct device is not supported yet."""

    def __init__(self, ndev: int, device: torch.device | str = "cuda"):
        if isinstance(device, (list, tuple)):
            devices = {torch.device(d) for d in device}
            if len(devices) != 1:
                raise NotImplementedError(
                    "a row mesh over several devices needs the multi-card "
                    "collectives, which are not ported: "
                    f"{sorted(map(str, devices))}")
            device = devices.pop()
        if ndev < 1:
            raise ValueError(f"a row mesh needs a shard, got {ndev}")
        self.ndev = int(ndev)
        self.device = torch.device(device)

    def __repr__(self) -> str:
        return f"RowMesh(ndev={self.ndev}, device={str(self.device)!r})"

    def shift_open(self, send: torch.Tensor, step: int) -> torch.Tensor:
        """Non-cyclic ppermute ``s → s + step`` (``recv[s + step] =
        send[s]``): the shards at the mesh end that nothing reaches receive
        zeros."""
        recv = torch.zeros_like(send)
        if step == 0:
            recv.copy_(send)
        elif abs(step) < self.ndev:
            if step > 0:
                recv[step:] = send[:-step]
            else:
                recv[:step] = send[-step:]
        return recv

    def shift_ring(self, send: torch.Tensor, step: int) -> torch.Tensor:
        """Cyclic ppermute ``s → (s + step) mod ndev``."""
        return torch.roll(send, step, 0)

    def all_to_all(self, blocks: torch.Tensor) -> torch.Tensor:
        """``blocks[s, t]`` is what shard ``s`` sends to shard ``t``;
        returns ``recv[t, s] = blocks[s, t]``."""
        return blocks.transpose(0, 1).contiguous()

    def all_gather(self, parts: torch.Tensor) -> torch.Tensor:
        """The ``(ndev, n)`` per-shard parts concatenated, as every shard
        receives them (one copy: all shards share the device)."""
        return parts.reshape(-1)

    def boundary_halo(self, x: torch.Tensor, h: int) -> torch.Tensor:
        """``(ndev, 2, h)``: for each shard, the last ``h`` entries of its
        left neighbour and the first ``h`` of its right neighbour, zero at
        the mesh ends (the two non-cyclic shifts of
        ``windowed_take_sharded``), as K4 and ``hyb_spmv_sharded`` read it:
        one ``halo_fill`` launch on the card."""
        return gather.halo_fill(x, self.ndev, h)


def make_row_mesh(n_devices: int, device: torch.device | str = "cuda"
                  ) -> RowMesh:
    """Row mesh of ``n_devices`` shards on ``device`` (a device, or a list
    of devices that must all be the same one)."""
    return RowMesh(n_devices, device)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _pad_rows(t: torch.Tensor, npad: int, fill=0) -> torch.Tensor:
    """Pad the last (row) axis of ``t`` to ``npad`` with ``fill``."""
    extra = npad - t.shape[-1]
    if extra == 0:
        return t
    return torch.cat([t, t.new_full((*t.shape[:-1], extra), fill)], -1)


def repad_ell(a: ELL, row_multiple: int) -> ELL:
    """Grow the row padding so that npad is a multiple of
    ``row_multiple``; the new rows are empty."""
    npad = _round_up(a.npad, row_multiple)
    if npad == a.npad:
        return a
    return dataclasses.replace(
        a, cols=_pad_rows(a.cols, npad), vals=_pad_rows(a.vals, npad),
        rownnz=_pad_rows(a.rownnz, npad),
        vals_t=None if a.vals_t is None else _pad_rows(a.vals_t, npad))


def shard_ell(a: ELL, mesh: RowMesh) -> ELL:
    """``a`` on the mesh's device with npad a multiple of ``ndev · 8``."""
    a = repad_ell(a, mesh.ndev * 8)
    return dataclasses.replace(
        a, cols=a.cols.to(mesh.device), vals=a.vals.to(mesh.device),
        rownnz=a.rownnz.to(mesh.device),
        vals_t=None if a.vals_t is None else a.vals_t.to(mesh.device))


def shard_operator(a, mesh: RowMesh):
    """Row-shard a level operator (ELL or DIA+ELL hybrid)."""
    if isinstance(a, HYB):
        npad = _round_up(a.npad, mesh.ndev * 8)
        # the remainder shares the hybrid's rows
        ell = shard_ell(a.ell, mesh) if a.ell is not None else None
        return dataclasses.replace(
            a, dvals=_pad_rows(a.dvals, npad).to(mesh.device), ell=ell)
    return shard_ell(a, mesh)


def replicate(tree, mesh: RowMesh):
    """Every shard reads the same copy: on one device, the object itself."""
    return tree


def shard_vector(v: torch.Tensor, mesh: RowMesh) -> torch.Tensor:
    """A level vector split over the mesh's shards (its length must divide
    evenly)."""
    if v.shape[0] % mesh.ndev:
        raise ValueError(f"length {v.shape[0]} does not split into "
                         f"{mesh.ndev} shards")
    return v.to(mesh.device)


def shard_hierarchy(hier: Hierarchy, mesh: RowMesh,
                    shard_levels: int = 1) -> Hierarchy:
    """Distribute a built hierarchy over the mesh.

    The finest ``shard_levels`` levels are row-sharded: a banded operator
    whose halo fits a shard becomes a :class:`~.halo.HaloOp` (halo
    exchange; its ELL remainder rides the index-list exchange, or the
    all-gather), a plain ELL an :class:`~.exchange.ExchangeELL`.  Labels
    are padded with -1 (excluded) and the smoother's diagonal with 1.0, so
    the repadding never changes the operator.  Only Chebyshev smoothers
    and label transfers are sharded; any other smoother kind and a
    weighted (smoothed) transfer plan are refused.  The transfers keep their K1
    arrays, rebuilt where a level's padding grew.  Deeper levels and the
    coarse LU are unchanged.
    """
    from .exchange import exchange_ell
    from .halo import halo_width, make_halo_op
    if any(lvl.tplan.weighted for lvl in hier.levels):
        # a smoothed P's coarse operators are P_sᵀ A P_s: the label
        # transfers the sharded levels rebuild would apply another operator
        raise NotImplementedError(
            "shard_hierarchy does not shard weighted (smoothed) transfers")
    kinds = sorted({lvl.smoother.kind for lvl in hier.levels} - {"chebyshev"})
    if kinds:
        raise NotImplementedError(
            f"shard_hierarchy takes Chebyshev smoothers only, the hierarchy "
            f"has {kinds}: their triangular parts and ILU factors are not "
            "sharded")
    ndev = mesh.ndev
    levels = []
    for idx, lvl in enumerate(hier.levels):
        if idx >= shard_levels:
            levels.append(lvl)
            continue
        a = shard_operator(lvl.a, mesh)
        if getattr(a, "offsets", None) and halo_width(a) <= a.npad // ndev:
            a = make_halo_op(a, mesh)
        elif isinstance(a, ELL):
            a = exchange_ell(a, mesh) or a
        sm = dataclasses.replace(
            lvl.smoother, d=_pad_rows(lvl.smoother.d, a.npad, 1.0))
        levels.append(dataclasses.replace(
            lvl, a=a, labels=_pad_rows(lvl.labels, a.npad, -1), smoother=sm))
    # each transfer maps its level's npad to the next level's: rebuild the
    # K1 arrays where either side was repadded
    for idx, lvl in enumerate(levels):
        nc_pad = levels[idx + 1].a.npad if idx + 1 < len(levels) \
            else lvl.nc_pad
        if (lvl.a.npad, nc_pad) != (hier.levels[idx].a.npad, lvl.nc_pad):
            levels[idx] = dataclasses.replace(
                lvl, nc_pad=nc_pad, tplan=tf.build_transfer_plan(
                    lvl.labels, nc_pad, lvl.smoother.d.dtype))
    return dataclasses.replace(hier, levels=tuple(levels))
