"""Halo-exchange SpMV over a row mesh.

For banded operators (the DIA part of the HYB format: stencil problems)
each shard needs only a halo of width W = max|offset| from each
neighbouring shard, not the whole of x: per SpMV each shard sends its W
boundary entries to its neighbours (2W entries instead of n).  The
interior multiply reads the shard's own block only, so it does not wait on
the exchange; the halo values enter through O(W) boundary corrections
added afterwards.  An operator whose lanes lean one way (a strictly lower
or upper half of gs2) reads, and over ranks exchanges, one side only.

The ELL remainder (irregular entries; coarse levels) rides the index-list
exchange of ``exchange.py`` — one ``all_to_all`` of exactly the off-shard
x entries it references — or the all-gather when no plan could be built.

Per SpMV: the halo fill (``RowMesh.boundary_halo``), the index-list
exchange where the plan has one, then one ``hyb_spmv_sharded`` launch for
every shard's interior, remainder and corrections.  On a mesh over ranks
the operator holds this rank's rows only, the halo's outer edges and the
exchange buffer come from the other ranks, and the launch covers the
rank's ``nlocal`` shards; the all-gather route then reads the gathered x
as the exchange buffer of every local shard (its columns shifted past the
shard's own rows).  Where the halo exceeds a shard (a hybrid with far
lanes over ranks) no neighbour holds it: x is all-gathered and the halo
taken from it by K2.  The halo is the
non-cyclic one K4 reads (zeros at the mesh ends); the JAX package's ring
exchange carries the far end's values there instead, but the dval lanes
are 0 wherever i + o leaves [0, n), so the two give the same bits.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..ops import gather
from ..sparse.formats import ELL
from ..sparse.hybrid import HYB
from .exchange import (build_exchange_plan, exchange_ell, gathered_cols,
                       plan_pattern, remainder_recv, shard_blocks)
from .sharded import RowMesh, _round_up, local_hybrid


def halo_width(a: HYB, multiple: int = 8) -> int:
    if not a.offsets:
        return 0
    return _round_up(max(abs(o) for o in a.offsets), multiple)


@dataclass
class HaloOp:
    """A row-sharded HYB operator bound to its mesh: ``ops.spmv`` routes
    it through the halo exchange.

    ``rest_cols``/``rest_vals`` hold the ELL remainder as per-shard blocks
    ``(ndev, K, npr)``: with an index-list exchange plan (``ex_send_idx``,
    ``ex_L``) the columns are remapped into each shard's
    ``[x_local | recv]``; without one they are the global columns, read
    from the all-gathered x.  ``halo_idx`` (``(nlocal, 2, w)`` int32, with
    ``halo_ok`` masking the rows past the level's ends) is set where the
    halo exceeds a shard: the halo is then K2's gather from the
    all-gathered x.

    Every other attribute forwards to the wrapped HYB, so the smoothers
    and ``extract_diag`` see a plain HYB.
    """

    a: HYB
    mesh: RowMesh
    rest_cols: torch.Tensor | None = None
    rest_vals: torch.Tensor | None = None
    ex_send_idx: torch.Tensor | None = None
    ex_L: int | None = None
    halo_idx: torch.Tensor | None = None
    halo_ok: torch.Tensor | None = None

    def __getattr__(self, name):
        if name in ("a", "mesh", "rest_cols", "rest_vals", "ex_send_idx",
                    "ex_L", "halo_idx", "halo_ok"):
            raise AttributeError(name)
        return getattr(self.a, name)

    @property
    def route(self) -> str:
        """How the remainder reaches off-shard x: ``"none"`` (pure DIA),
        ``"exchange"`` (index-list plan) or ``"all_gather"``."""
        if self.rest_cols is None:
            return "none"
        return "exchange" if self.ex_send_idx is not None else "all_gather"

    def halo(self, x: torch.Tensor) -> torch.Tensor | None:
        """The halo one SpMV reads: the neighbours' boundary slabs of the
        sides the lanes reach (``RowMesh.boundary_halo``), or K2's gather
        from the all-gathered x where the halo exceeds a shard."""
        w = halo_width(self.a)
        if not w:
            return None
        if self.halo_idx is not None:
            got = gather.take(self.halo_idx, self.mesh.gather_rows(x))
            return torch.where(self.halo_ok, got, 0.0)
        lanes = self.a.lanes
        return self.mesh.boundary_halo(x, w, left=lanes.omin < 0,
                                       right=lanes.omax > 0)

    def kernel_args(self, x: torch.Tensor):
        """The arguments of the one ``hyb_spmv_sharded`` launch of an SpMV
        of ``x`` (the halo and the exchange run here, collectives over
        ranks): ``(args, kwargs)``."""
        a, mesh = self.a, self.mesh
        x = x.contiguous()
        recv, route = remainder_recv(x, mesh, self.route, self.ex_send_idx,
                                     self.ex_L)
        return (a.dvals, a.lanes, x, mesh.nlocal), dict(
            halo=self.halo(x), cols=self.rest_cols, vals=self.rest_vals,
            recv=recv, route=route)

    def spmv(self, x: torch.Tensor) -> torch.Tensor:
        args, kw = self.kernel_args(x)
        return gather.hyb_spmv_sharded(*args, **kw)


def _gathered_halo(npad: int, w: int, mesh: RowMesh):
    """The K2 index of a halo of ``w`` rows on either side of each local
    shard into the whole (all-gathered) x of ``npad`` rows, clamped, and
    the mask of the rows that lie inside the level."""
    npr = npad // mesh.ndev
    first = (mesh.first_shard + torch.arange(mesh.nlocal)) * npr
    k = torch.arange(w)
    rows = torch.stack([first[:, None] - w + k, first[:, None] + npr + k], 1)
    ok = (rows >= 0) & (rows < npad)
    return rows.clamp(0, npad - 1).to(torch.int32), ok


def make_halo_op(a: HYB, mesh: RowMesh) -> HaloOp:
    """Bind a sharded HYB (whole, npad a multiple of ``ndev``) to the
    mesh, building the remainder's index-list exchange plan from its
    nonzero pattern (one host read) when one exists and is cheaper than
    the all-gather.  Over ranks the plan is built from the whole pattern
    and this rank's rows of it are kept.  Where the halo exceeds a shard
    the halo is read from the all-gathered x."""
    ndev, nl = mesh.ndev, mesh.nlocal
    local = local_hybrid(a, mesh)
    wide = {}
    if halo_width(a) > a.npad // ndev:
        idx, ok = _gathered_halo(a.npad, halo_width(a), mesh)
        wide = dict(halo_idx=idx.to(a.device), halo_ok=ok.to(a.device))
    if a.ell is None:
        return HaloOp(a=local, mesh=mesh, **wide)
    ell = a.ell
    lo, hi = mesh.local_rows(a.npad)
    mine = slice(mesh.first_shard, mesh.first_shard + nl)
    plan = build_exchange_plan(plan_pattern(ell.cols, ell.vals),
                               ell.rownnz.cpu().numpy(), ndev)
    vals = shard_blocks(ell.vals[:, lo:hi], nl)
    if plan is None:
        cols = gathered_cols(ell.cols[:, lo:hi], mesh, a.npad)
        return HaloOp(a=local, mesh=mesh, rest_cols=shard_blocks(cols, nl),
                      rest_vals=vals, **wide)
    dev = ell.cols.device
    return HaloOp(
        a=local, mesh=mesh,
        rest_cols=shard_blocks(torch.from_numpy(plan.cols[:, lo:hi]).to(dev),
                               nl),
        rest_vals=vals,
        ex_send_idx=torch.from_numpy(plan.send_idx[mine]).to(
            device=dev, dtype=torch.int64),
        ex_L=plan.L, **wide)


def bind_operator(a, mesh: RowMesh):
    """A whole operator of a sharded level (HYB or ELL, npad a multiple of
    ``ndev · 8``, on the mesh's device) bound to the mesh, as
    ``shard_hierarchy`` binds levels and their smoother state: a hybrid
    becomes a :class:`HaloOp` where it has lanes whose halo fits a shard,
    and always over ranks; in one process a hybrid without lanes or with
    a halo wider than a shard stays whole (K1 on the whole x), as the JAX
    package leaves such a level to an XLA SpMV; an ELL becomes an
    :class:`~.exchange.ExchangeELL`."""
    if isinstance(a, ELL):
        return exchange_ell(a, mesh)
    if mesh.over_ranks or (a.offsets and halo_width(a) <= a.npad // mesh.ndev):
        return make_halo_op(a, mesh)
    return a


def spmv_route(op) -> str:
    """How a sharded level's SpMV reaches off-shard x: ``"none"`` (its
    own rows and the halo), ``"exchange"`` (the index-list exchange) or
    ``"all_gather"`` (the whole x; also an operator left whole in one
    process)."""
    if isinstance(op, HaloOp):
        return "all_gather" if op.halo_idx is not None else op.route
    return getattr(op, "route", "all_gather")


def make_halo_spmv(a: HYB, mesh: RowMesh):
    """y = A @ x over row-sharded x (the function form of
    :class:`HaloOp`)."""
    return make_halo_op(a, mesh).spmv
