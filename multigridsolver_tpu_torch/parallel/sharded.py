"""Row-partitioned levels over a row mesh.

The scaling axis is matrix-row partitioning: a level of ``npad`` rows is
split into ``ndev`` shards of ``npr = npad / ndev`` consecutive rows, and
level vectors are split the same way.  :class:`RowMesh` is the
counterpart of the JAX package's one-axis ``Mesh``: it names the shards
and owns the collectives the sharded path uses (the boundary halo,
``all_to_all``, ``all_gather`` and the all-reduces).

A mesh lives in one process, or spans ranks:

* **one process**: all shards on one device, as the JAX package's
  single-process mesh of virtual CPU devices; a sharded array is the
  whole array on that device, shard ``s`` its rows ``[s·npr, (s+1)·npr)``,
  and each collective is a device-local copy with the collective's
  semantics;
* **over ranks** (``parallel/multihost.py``): one rank per card, rank
  ``r`` holding ``nlocal`` consecutive shards, and of each sharded level
  only those rows; the collectives run on the rank's transport (NCCL
  between cards, gloo on the CPU), outside the kernels, which run on the
  local block with the halo and exchange buffers received.

Only the finest levels are worth sharding; deeper levels and the dense
coarse LU stay replicated.
"""
from __future__ import annotations

import dataclasses

import torch

from ..ops import gather
from ..setup import transfers as tf
from ..solve.hierarchy import Hierarchy
from ..solve.smoothers import KINDS as SMOOTHER_KINDS, Smoother
from ..sparse.formats import ELL
from ..sparse.hybrid import HYB


class RowMesh:
    """``ndev`` row shards: on one ``device`` in one process, or over
    the ranks of ``comm`` (a ``multihost.RankComm``), ``nlocal = ndev /
    world`` consecutive shards on each rank's device.

    The collectives take this rank's per-shard blocks stacked on a
    leading axis of length ``nlocal`` (``send[s]`` is what local shard
    ``s`` contributes) and return what each local shard receives, stacked
    the same way.  In one process ``nlocal = ndev``.  A device list in
    one process must name a single device."""

    def __init__(self, ndev: int, device: torch.device | str = "cuda",
                 comm=None):
        if isinstance(device, (list, tuple)):
            devices = {torch.device(d) for d in device}
            if len(devices) != 1:
                raise NotImplementedError(
                    "a row mesh in one process takes one device; a mesh "
                    "over several cards runs one rank per card "
                    "(parallel.multihost.global_row_mesh): "
                    f"{sorted(map(str, devices))}")
            device = devices.pop()
        if ndev < 1:
            raise ValueError(f"a row mesh needs a shard, got {ndev}")
        world = 1 if comm is None else comm.world
        if ndev % world:
            raise ValueError(f"{ndev} shards do not split over {world} "
                             "ranks")
        self.ndev = int(ndev)
        self.device = torch.device(device)
        self.comm = comm if world > 1 else None
        self.world = world
        self.rank = 0 if self.comm is None else comm.rank
        self.nlocal = self.ndev // world
        self.first_shard = self.rank * self.nlocal

    @property
    def over_ranks(self) -> bool:
        return self.comm is not None

    def __repr__(self) -> str:
        if self.over_ranks:
            return (f"RowMesh(ndev={self.ndev}, device={str(self.device)!r}, "
                    f"rank={self.rank}/{self.world})")
        return f"RowMesh(ndev={self.ndev}, device={str(self.device)!r})"

    def local_rows(self, npad: int) -> tuple[int, int]:
        """This rank's rows ``[lo, hi)`` of a level of ``npad`` rows."""
        npr = npad // self.ndev
        return self.first_shard * npr, (self.first_shard + self.nlocal) * npr

    def shift_open(self, send: torch.Tensor, step: int) -> torch.Tensor:
        """Non-cyclic ppermute ``s → s + step`` (``recv[s + step] =
        send[s]``): the shards at the mesh end that nothing reaches receive
        zeros.  One process only."""
        self._one_process("shift_open")
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
        """Cyclic ppermute ``s → (s + step) mod ndev``.  One process
        only."""
        self._one_process("shift_ring")
        return torch.roll(send, step, 0)

    def _one_process(self, what: str) -> None:
        if self.over_ranks:
            raise NotImplementedError(f"{what} runs on a one-process mesh")

    def all_to_all(self, blocks: torch.Tensor) -> torch.Tensor:
        """``blocks[s, t]`` ``(nlocal, ndev, L)`` is what local shard ``s``
        sends to shard ``t``; returns ``recv[t, s]`` ``(nlocal, ndev, L)``,
        what local shard ``t`` receives from shard ``s``.  Over ranks one
        ``all_to_all_single`` of the rank-major block."""
        if not self.over_ranks:
            return blocks.transpose(0, 1).contiguous()
        nl, w = self.nlocal, self.world
        L = blocks.shape[-1]
        # chunk q (rank q's shards) first: (world, nl_src, nl_dst, L)
        send = blocks.view(nl, w, nl, L).permute(1, 0, 2, 3)
        recv = self.comm.all_to_all(send)
        # (world_src, nl_src, nl_dst, L) → (nl_dst, ndev_src, L)
        return recv.permute(2, 0, 1, 3).contiguous().view(nl, self.ndev, L)

    def all_gather(self, parts: torch.Tensor) -> torch.Tensor:
        """The ``(nlocal, n)`` per-shard parts of every rank concatenated
        in shard order, as every shard receives them (one copy in one
        process: all shards share the device)."""
        if not self.over_ranks:
            return parts.reshape(-1)
        return self.comm.all_gather(parts)

    def rank_values(self, t: torch.Tensor) -> torch.Tensor:
        """``(world,)``: every rank's scalar ``t``, in rank order."""
        if not self.over_ranks:
            return t.reshape(1)
        return self.comm.all_gather(t.reshape(1))

    def allreduce_sum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of ``t`` over the ranks (``t`` itself in one
        process)."""
        return self.comm.all_reduce(t, "sum") if self.over_ranks else t

    def allreduce_max(self, t: torch.Tensor) -> torch.Tensor:
        """The maximum of ``t`` over the ranks; a bool is an any."""
        if not self.over_ranks:
            return t
        if t.dtype == torch.bool:
            return self.comm.all_reduce(t.to(torch.int32), "max") != 0
        return self.comm.all_reduce(t, "max")

    def dot(self, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        """The dot product of two vectors split over the mesh: the local
        one, all-reduced."""
        return self.allreduce_sum(torch.dot(u, v))

    def row_halo(self, t: torch.Tensor, h: int, left: bool = True,
                 right: bool = True):
        """The boundary rows of the neighbour ranks for a ``(..., nloc)``
        field: ``(left, right)``, the last ``h`` columns of rank − 1 and
        the first ``h`` of rank + 1, None at the mesh ends (both None in
        one process, where every row is local).  A side not asked for is
        not exchanged (None): a strictly lower operator reads only the
        left one, so every rank sends only toward the next."""
        if not self.over_ranks or h == 0:
            return None, None
        n = t.shape[-1]
        return self.comm.exchange(t[..., :h] if right else None,
                                  t[..., n - h:] if left else None)

    def boundary_halo(self, x: torch.Tensor, h: int, left: bool = True,
                      right: bool = True) -> torch.Tensor:
        """``(nlocal, 2, h)``: for each local shard, the last ``h``
        entries of its left neighbour and the first ``h`` of its right
        neighbour, zero at the mesh ends (the two non-cyclic shifts of
        ``windowed_take_sharded``), as K4 and ``hyb_spmv_sharded`` read
        it: one ``halo_fill`` launch on the card, whose outer edges are,
        over ranks, the slabs received from the neighbour ranks (zeros on
        a side not asked for)."""
        if not self.over_ranks or h == 0:
            return gather.halo_fill(x, self.nlocal, h)
        lo, hi = self.row_halo(x, h, left, right)
        return gather.halo_fill(x, self.nlocal, h, lo, hi)

    def gather_rows(self, t: torch.Tensor) -> torch.Tensor:
        """A ``(..., nloc)`` field of this rank's rows made whole, ``(...,
        ndev · npr)``, on every rank: one all-gather (``t`` itself in one
        process, where it is whole).  A bool field travels as its
        bytes."""
        if not self.over_ranks:
            return t
        flag = t.dtype == torch.bool
        g = self.comm.all_gather(t.view(torch.uint8) if flag else t)
        if t.dim() > 1:
            g = g.view(self.world, -1, t.shape[-1]).transpose(0, 1) \
                .reshape(*t.shape[:-1], -1)
        return g.view(torch.bool) if flag else g


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


def on_device(a: ELL, device: torch.device) -> ELL:
    """``a``'s arrays on ``device``."""
    return dataclasses.replace(
        a, cols=a.cols.to(device), vals=a.vals.to(device),
        rownnz=a.rownnz.to(device),
        vals_t=None if a.vals_t is None else a.vals_t.to(device))


def halo_reach(a: ELL, ndev: int, transposed: bool = False) -> int:
    """How far any shard's stored columns reach before its first row or
    past its last (``a`` whole, split into ``ndev`` shards); with
    ``transposed`` also how far the rows that store a column of a shard
    lie from it (a nonsymmetric pattern's column sums need those rows)."""
    npr = a.npad // ndev
    valid = a.slot_mask()
    big = torch.iinfo(torch.int32).max
    lo = torch.where(valid, a.cols, big).view(a.k, ndev, npr).amin((0, 2))
    hi = torch.where(valid, a.cols, -1).view(a.k, ndev, npr).amax((0, 2))
    spans = list(zip(lo.tolist(), hi.tolist()))
    if transposed:
        # per shard of columns: the least and greatest row storing one
        owner = torch.where(valid, a.cols, 0).long() // npr
        rows = a.row_iota().long()
        rlo = torch.full((ndev,), big, dtype=torch.long, device=a.device)
        rhi = torch.full((ndev,), -1, dtype=torch.long, device=a.device)
        rlo.scatter_reduce_(0, owner[valid], rows[valid], "amin")
        rhi.scatter_reduce_(0, owner[valid], rows[valid], "amax")
        spans += list(zip(rlo.tolist(), rhi.tolist()))
    over = 0
    for i, (l, u) in enumerate(spans):
        s = i % ndev
        if u >= 0:
            over = max(over, s * npr - l, u - ((s + 1) * npr - 1))
    return over


def local_ell(a: ELL, mesh: RowMesh, h: int | None) -> ELL:
    """This rank's rows of ``a`` (whole, npad a multiple of ``ndev``),
    marked ``shard = (mesh, npr, h)``: its neighbour gathers read the
    neighbour ranks' rows through a halo of ``h``, or (``h`` None: the
    halo would exceed a shard) from the whole field, all-gathered."""
    lo, hi = mesh.local_rows(a.npad)

    def rows(t):
        return None if t is None else t[..., lo:hi].contiguous()
    return dataclasses.replace(
        a, cols=rows(a.cols), vals=rows(a.vals), rownnz=rows(a.rownnz),
        vals_t=rows(a.vals_t), shard=(mesh, a.npad // mesh.ndev, h))


def shard_ell(a: ELL, mesh: RowMesh) -> ELL:
    """``a`` on the mesh's device with npad a multiple of ``ndev · 8``.
    Over ranks only this rank's rows are kept, marked for the halo its
    columns need, or for gathers from the whole field where that halo
    exceeds a shard."""
    a = on_device(repad_ell(a, mesh.ndev * 8), mesh.device)
    if not mesh.over_ranks:
        return a
    h = halo_reach(a, mesh.ndev, transposed=True)
    return local_ell(a, mesh, h if h <= a.npad // mesh.ndev else None)


def _repad_hybrid(a: HYB, mesh: RowMesh) -> HYB:
    """``a`` whole on the mesh's device, npad a multiple of ``ndev · 8``
    (the remainder shares the hybrid's rows)."""
    npad = _round_up(a.npad, mesh.ndev * 8)
    ell = None if a.ell is None \
        else on_device(repad_ell(a.ell, mesh.ndev * 8), mesh.device)
    return dataclasses.replace(
        a, dvals=_pad_rows(a.dvals, npad).to(mesh.device), ell=ell)


def local_hybrid(a: HYB, mesh: RowMesh) -> HYB:
    """This rank's rows of a whole hybrid (its own object in one
    process)."""
    if not mesh.over_ranks:
        return a
    lo, hi = mesh.local_rows(a.npad)
    ell = None
    if a.ell is not None:
        ell = dataclasses.replace(
            a.ell, cols=a.ell.cols[:, lo:hi].contiguous(),
            vals=a.ell.vals[:, lo:hi].contiguous(),
            rownnz=a.ell.rownnz[lo:hi].contiguous(), vals_t=None)
    return dataclasses.replace(a, dvals=a.dvals[:, lo:hi].contiguous(),
                               ell=ell)


def shard_operator(a, mesh: RowMesh):
    """Row-shard a level operator (ELL or DIA+ELL hybrid); over ranks,
    this rank's rows of it."""
    if isinstance(a, HYB):
        return local_hybrid(_repad_hybrid(a, mesh), mesh)
    return shard_ell(a, mesh)


def repad_operator(a, mesh: RowMesh):
    """A level operator (ELL or hybrid) whole on the mesh's device, npad
    a multiple of ``ndev · 8`` (the new rows empty)."""
    if isinstance(a, HYB):
        return _repad_hybrid(a, mesh)
    return on_device(repad_ell(a, mesh.ndev * 8), mesh.device)


def replicate(tree, mesh: RowMesh):
    """Every shard reads the same copy: the object itself (over ranks
    every rank holds its own, built identically)."""
    return tree


def shard_vector(v: torch.Tensor, mesh: RowMesh) -> torch.Tensor:
    """A level vector split over the mesh's shards (its length must divide
    evenly): in one process the whole vector on the mesh's device, over
    ranks this rank's rows of it."""
    if v.shape[0] % mesh.ndev:
        raise ValueError(f"length {v.shape[0]} does not split into "
                         f"{mesh.ndev} shards")
    lo, hi = mesh.local_rows(v.shape[0])
    return v[lo:hi].to(mesh.device)


class RankTransfer:
    """The label transfers of a level sharded over ranks.

    Aggregates are numbered in leader order (an aggregate's leader is its
    smallest member), so the coarse rows whose leader lies on rank ``r``
    form one range.  Rank ``r`` restricts those rows: K1 over their
    members-ELL, reading its own block of ``v`` and, where the members
    reach past its last row, the first ``reach`` entries of rank ``r + 1``
    (one neighbour exchange), or, where they reach past what rank
    ``r + 1`` holds (a permuted grid), the whole ``v``, all-gathered.
    Each coarse row adds its members in
    ascending order, as on one process, so the bits are the same.  One
    all-gather of the per-rank ranges (each padded to the longest, plus a
    zero) and one K2 gather assemble the coarse vector, whose own block a
    sharded coarse level keeps.  Prolongation is K1's gather of the whole
    coarse vector (all-gathered first when the coarse level is sharded).
    ``restrict_fast``/``prolong_fast`` dispatch here through ``mesh``."""

    weighted = False

    def __init__(self, labels: torch.Tensor, nc_pad: int, dtype,
                 mesh: RowMesh, coarse_sharded: bool):
        npad = labels.shape[0]
        lo, hi = mesh.local_rows(npad)
        world, per_rank = mesh.world, hi - lo
        nc_t = _round_up(nc_pad, tf.T)
        m_cols, m_vals = tf._members_ell(labels, nc_t, dtype)
        has = m_vals[0] > 0
        nc = int(has.sum())
        first = m_cols[0, :nc].long()
        if not (bool(has[:nc].all())
                and bool((first[1:] > first[:-1]).all())):
            raise ValueError("the aggregates are not numbered in leader "
                             "order: the ranks' coarse rows would not form "
                             "ranges")
        owner = first // per_rank
        counts = torch.bincount(owner, minlength=world).tolist()
        starts = [sum(counts[:q]) for q in range(world)]
        width = max(counts) + 1
        reach = 0
        for q in range(world):
            blk = m_cols[:, starts[q]:starts[q] + counts[q]]
            ok = m_vals[:, starts[q]:starts[q] + counts[q]] > 0
            if counts[q]:
                last = int(torch.where(ok, blk, -1).max())
                reach = max(reach, last - (q + 1) * per_rank + 1)
        # past what the next rank holds, the members read the whole v
        self.gathered = reach > per_rank
        c0, cnt = starts[mesh.rank], counts[mesh.rank]
        cols = torch.where(m_vals[:, c0:c0 + cnt] > 0,
                           m_cols[:, c0:c0 + cnt]
                           - (0 if self.gathered else lo), 0)
        self.m_cols = _pad_rows(cols, width).to(torch.int32).contiguous()
        self.m_vals = _pad_rows(m_vals[:, c0:c0 + cnt], width).contiguous()
        # coarse row c lies at owner · width + (c − start[owner]) of the
        # gathered ranges; padding rows read rank 0's zero
        slot = torch.full((nc_pad,), width - 1, dtype=torch.int64,
                          device=labels.device)
        slot[:nc] = owner * width + torch.arange(
            nc, device=labels.device) - torch.tensor(
                starts, device=labels.device)[owner]
        self.compact = slot.to(torch.int32)
        own = labels[lo:hi]
        valid = own >= 0
        self.p_cols = torch.where(valid, own, 0).to(torch.int32)[None, :] \
            .contiguous()
        self.p_vals = valid.to(dtype)[None, :].contiguous()
        self.mesh, self.reach, self.nc_pad = mesh, reach, nc_pad
        self.npad_f = per_rank
        self.coarse_rows = mesh.local_rows(nc_pad) if coarse_sharded \
            else None

    def restrict(self, v: torch.Tensor) -> torch.Tensor:
        src = v
        if self.gathered:
            src = self.mesh.gather_rows(v)
        elif self.reach:
            _, right = self.mesh.comm.exchange(v[:self.reach], None)
            src = torch.cat([v, right if right is not None
                             else v.new_zeros((self.reach,))])
        part = gather.gather_spmv(self.m_cols, self.m_vals, src.contiguous())
        rc = gather.take(self.compact, self.mesh.comm.all_gather(part))
        if self.coarse_rows is not None:
            lo, hi = self.coarse_rows
            rc = rc[lo:hi].contiguous()
        return rc

    def prolong(self, xc: torch.Tensor, out_len: int) -> torch.Tensor:
        if self.coarse_rows is not None:
            xc = self.mesh.comm.all_gather(xc)
        return gather.gather_spmv(self.p_cols, self.p_vals, xc)[:out_len]


def _shard_smoother(sm: Smoother, npad: int, mesh: RowMesh) -> Smoother:
    """A sharded level's smoother state: the vectors padded to the level's
    ``npad`` (the diagonal and ILU's U diagonal with 1.0) and, over
    ranks, this rank's rows of them; gs2's triangular halves and ilu0's
    L and U factors, computed on the whole level before sharding, are
    repadded with empty rows and bound to the mesh as the level operator
    is (:func:`~.halo.bind_operator`), each with its own exchange plan."""
    from .halo import bind_operator

    def rows(t):
        lo, hi = mesh.local_rows(npad)
        t = _pad_rows(t, npad, 1.0)
        return t[lo:hi].contiguous() if mesh.over_ranks else t

    def bound(op):
        return bind_operator(repad_operator(op, mesh), mesh)

    state = dict(d=rows(sm.d))
    if sm.lower is not None:
        state.update(lower=bound(sm.lower), upper=bound(sm.upper))
    if sm.lmat is not None:
        state.update(lmat=bound(sm.lmat), umat=bound(sm.umat),
                     udiag=rows(sm.udiag))
    return dataclasses.replace(sm, **state)


def shard_hierarchy(hier: Hierarchy, mesh: RowMesh,
                    shard_levels: int = 1) -> Hierarchy:
    """Distribute a built hierarchy over the mesh.

    The finest ``shard_levels`` levels are row-sharded and bound to the
    mesh (:func:`~.halo.bind_operator`): a banded operator whose halo fits
    a shard becomes a :class:`~.halo.HaloOp` (halo exchange; its ELL
    remainder rides the index-list exchange, or the all-gather), a plain
    ELL an :class:`~.exchange.ExchangeELL` (the same two routes).  Labels
    are padded with -1 (excluded) and the smoother's vectors with 1.0, so
    the repadding never changes the operator.  Every smoother kind's
    state is sharded beside the level (:func:`_shard_smoother`); a
    weighted (smoothed) transfer plan is refused.  In one process the
    transfers keep their K1 arrays, rebuilt where a level's padding grew.
    Over ranks every rank passes the same whole hierarchy, and keeps of
    each sharded level only its own rows (operator, labels, smoother
    state), with :class:`RankTransfer` s from the whole labels; a
    hybrid whose halo exceeds a shard reads its halo from the all-gathered
    x.  Deeper levels and the coarse LU are unchanged (replicated).
    """
    from .halo import bind_operator
    if any(lvl.tplan.weighted for lvl in hier.levels):
        # a smoothed P's coarse operators are P_sᵀ A P_s: the label
        # transfers the sharded levels rebuild would apply another operator
        raise NotImplementedError(
            "shard_hierarchy does not shard weighted (smoothed) transfers")
    unknown = sorted({lvl.smoother.kind for lvl in hier.levels}
                     - set(SMOOTHER_KINDS))
    if unknown:
        raise NotImplementedError(
            f"shard_hierarchy does not know the smoother kinds {unknown}; "
            f"it shards {SMOOTHER_KINDS}")
    levels, npads, whole_labels = [], [], []
    for idx, lvl in enumerate(hier.levels):
        if idx >= shard_levels:
            levels.append(lvl)
            npads.append(lvl.a.npad)
            continue
        a = repad_operator(lvl.a, mesh)
        npad = a.npad
        labels = _pad_rows(lvl.labels, npad, -1)
        whole_labels.append(labels)
        if mesh.over_ranks:
            lo, hi = mesh.local_rows(npad)
            labels = labels[lo:hi].contiguous()
        levels.append(dataclasses.replace(
            lvl, a=bind_operator(a, mesh), labels=labels,
            smoother=_shard_smoother(lvl.smoother, npad, mesh)))
        npads.append(npad)
    # each transfer maps its level's npad to the next level's: rebuild the
    # K1 arrays where either side was repadded
    for idx, lvl in enumerate(levels):
        nc_pad = npads[idx + 1] if idx + 1 < len(levels) else lvl.nc_pad
        if mesh.over_ranks and idx < shard_levels:
            levels[idx] = dataclasses.replace(
                lvl, nc_pad=nc_pad, tplan=RankTransfer(
                    whole_labels[idx], nc_pad, lvl.smoother.d.dtype, mesh,
                    coarse_sharded=idx + 1 < min(shard_levels,
                                                 len(levels))))
        elif (npads[idx], nc_pad) != (hier.levels[idx].a.npad, lvl.nc_pad):
            levels[idx] = dataclasses.replace(
                lvl, nc_pad=nc_pad, tplan=tf.build_transfer_plan(
                    lvl.labels, nc_pad, lvl.smoother.d.dtype))
    return dataclasses.replace(hier, levels=tuple(levels))
