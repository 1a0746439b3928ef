"""Halo-exchange SpMV over a row mesh.

For banded operators (the DIA part of the HYB format: stencil problems)
each shard needs only a halo of width W = max|offset| from each
neighbouring shard, not the whole of x: per SpMV each shard sends its W
boundary entries to its neighbours (2W entries instead of n).  The
interior multiply reads the shard's own block only, so it does not wait on
the exchange; the halo values enter through O(W) boundary corrections
added afterwards.

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
shard's own rows).  The halo is the
non-cyclic one K4 reads (zeros at the mesh ends); the JAX package's ring
exchange carries the far end's values there instead, but the dval lanes
are 0 wherever i + o leaves [0, n), so the two give the same bits.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..ops import gather
from ..sparse.hybrid import HYB
from .exchange import build_exchange_plan, exchange_recv, shard_blocks
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
    from the all-gathered x.

    Every other attribute forwards to the wrapped HYB, so the smoothers
    and ``extract_diag`` see a plain HYB.
    """

    a: HYB
    mesh: RowMesh
    rest_cols: torch.Tensor | None = None
    rest_vals: torch.Tensor | None = None
    ex_send_idx: torch.Tensor | None = None
    ex_L: int | None = None

    def __getattr__(self, name):
        if name in ("a", "mesh", "rest_cols", "rest_vals", "ex_send_idx",
                    "ex_L"):
            raise AttributeError(name)
        return getattr(self.a, name)

    @property
    def route(self) -> str:
        """How the remainder reaches off-shard x: ``"none"`` (pure DIA),
        ``"exchange"`` (index-list plan) or ``"all_gather"``."""
        if self.rest_cols is None:
            return "none"
        return "exchange" if self.ex_send_idx is not None else "all_gather"

    def spmv(self, x: torch.Tensor) -> torch.Tensor:
        a, mesh = self.a, self.mesh
        nl = mesh.nlocal
        w = halo_width(a)
        x = x.contiguous()
        halo = mesh.boundary_halo(x, w) if w else None
        route, recv = self.route, None
        if self.ex_L:
            recv = exchange_recv(x.view(nl, -1), self.ex_send_idx, mesh)
        elif route == "all_gather" and mesh.over_ranks:
            recv = mesh.all_gather(x.view(nl, -1)).expand(nl, -1) \
                .contiguous()
            route = "exchange"
        return gather.hyb_spmv_sharded(
            a.dvals, a.lanes, x, nl, halo=halo, cols=self.rest_cols,
            vals=self.rest_vals, recv=recv, route=route)


def make_halo_op(a: HYB, mesh: RowMesh) -> HaloOp:
    """Bind a sharded HYB (whole, npad a multiple of ``ndev``) to the
    mesh, building the remainder's index-list exchange plan (one host
    read of the cols pattern) when one exists and is cheaper than the
    all-gather.  Over ranks the plan is built from the whole pattern and
    this rank's rows of it are kept."""
    ndev, nl = mesh.ndev, mesh.nlocal
    if halo_width(a) > a.npad // ndev:
        raise ValueError(f"halo {halo_width(a)} exceeds shard size "
                         f"{a.npad // ndev}; use the all-gather path")
    local = local_hybrid(a, mesh)
    if a.ell is None:
        return HaloOp(a=local, mesh=mesh)
    ell = a.ell
    lo, hi = mesh.local_rows(a.npad)
    mine = slice(mesh.first_shard, mesh.first_shard + nl)
    plan = build_exchange_plan(ell.cols.cpu().numpy(),
                               ell.rownnz.cpu().numpy(), ndev)
    vals = shard_blocks(ell.vals[:, lo:hi], nl)
    if plan is None:
        cols = ell.cols[:, lo:hi]
        if mesh.over_ranks:
            # the gathered x is every local shard's exchange buffer
            cols = cols + a.npad // ndev
        return HaloOp(a=local, mesh=mesh, rest_cols=shard_blocks(cols, nl),
                      rest_vals=vals)
    dev = ell.cols.device
    return HaloOp(
        a=local, mesh=mesh,
        rest_cols=shard_blocks(torch.from_numpy(plan.cols[:, lo:hi]).to(dev),
                               nl),
        rest_vals=vals,
        ex_send_idx=torch.from_numpy(plan.send_idx[mine]).to(
            device=dev, dtype=torch.int64),
        ex_L=plan.L)


def make_halo_spmv(a: HYB, mesh: RowMesh):
    """y = A @ x over row-sharded x (the function form of
    :class:`HaloOp`)."""
    return make_halo_op(a, mesh).spmv
