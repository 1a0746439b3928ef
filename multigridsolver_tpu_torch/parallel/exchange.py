"""Index-list exchange for irregular sharded operators.

The banded (DIA) part of a sharded operator moves a contiguous width-W
halo between mesh neighbours (``halo.py``).  The ELL remainder and coarse
ELL levels reference scattered off-shard columns; an all-gather of x
serves them with n entries per SpMV however few are needed.

This module builds AGMG-MPI's ``lstout/lstin`` exchange lists: at shard
time, for every ordered shard pair (s → t), the sorted unique x indices
owned by s that t's rows reference.  The lists are padded to one length
L, so the whole exchange is one ``all_to_all`` of an ``(ndev, ndev, L)``
block, and the operator's columns are rewritten once, on the host, to
address each shard's ``[x_local | recv]``.  Per SpMV each shard then
moves ndev·L entries instead of n, and one ``hyb_spmv_sharded`` launch
runs every shard's rows, reading ``x_local`` and ``recv`` in place.

When a shard pair shares no columns its list is empty; when every pair is
empty, no exchange runs at all.  When the lists approach the all-gather's
volume the plan is refused, and the operator takes the all-gather route:
in one process the kernel reads the whole x; over ranks one all-gather of
x per SpMV is every local shard's exchange buffer.  A slot that stores a
zero value (the other triangle of a split operator, an ILU factor on its
level's pattern) references nothing: each operator's plan is built from
its own nonzero pattern (:func:`plan_pattern`).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..ops import gather
from .sharded import RowMesh, _round_up


@dataclass(frozen=True)
class ExchangePlan:
    """Static exchange metadata and host arrays.

    ``send_idx[s, t, :]`` — indices (local to shard s) of the x entries
    shard s sends to shard t; entries past the true list length are 0
    (sent but unused).  ``cols`` — the operator's column indices
    rewritten per owning shard to address ``[x_local | recv.ravel()]``
    (length n_local + ndev·L).  ``L = 0`` ⇔ no cross-shard references.
    """

    send_idx: np.ndarray   # (ndev, ndev, L) int32
    cols: np.ndarray       # (K, npad) int32, remapped per shard
    L: int
    ndev: int
    n_local: int


def build_exchange_plan(cols: np.ndarray, rownnz: np.ndarray,
                        ndev: int) -> ExchangePlan | None:
    """Build send lists + remapped columns from host-side ELL arrays.

    Returns None when the exchange would move at least as much as an
    all-gather (L·ndev ≥ n_local) — caller keeps the all-gather path.
    """
    K, npad = cols.shape
    if npad % ndev != 0:
        return None
    nl = npad // ndev
    sl = np.arange(K, dtype=np.int32)[:, None]
    valid = sl < rownnz[None, :]
    c = np.where(valid, cols, 0).astype(np.int64)

    lists: dict[tuple[int, int], np.ndarray] = {}
    lmax = 0
    for t in range(ndev):
        blk = np.s_[:, t * nl:(t + 1) * nl]
        cb = c[blk][valid[blk]]
        owner = cb // nl
        remote = cb[owner != t]
        if remote.size == 0:
            continue
        for s in np.unique(remote // nl):
            u = np.unique(remote[remote // nl == s])
            lists[(int(s), t)] = u
            lmax = max(lmax, len(u))

    L = _round_up(lmax, 8) if lmax else 0
    # refuse when the exchange approaches all-gather volume: each shard
    # sends/receives ndev·L entries vs ~npad for the all-gather — demand
    # a 2x margin so the plan never loses to what it replaces
    if L * ndev >= npad // 2:
        return None

    send_idx = np.zeros((ndev, ndev, max(L, 1)), np.int32)[:, :, :L]
    newcols = np.zeros((K, npad), np.int32)
    for t in range(ndev):
        blk = np.s_[:, t * nl:(t + 1) * nl]
        cb = c[blk]
        owner = cb // nl
        nc = np.where(owner == t, cb - t * nl, 0).astype(np.int32)
        for s in range(ndev):
            if (s, t) not in lists:
                continue
            u = lists[(s, t)]
            send_idx[s, t, :len(u)] = (u - s * nl).astype(np.int32)
            m = owner == s
            nc[m] = (nl + s * L
                     + np.searchsorted(u, cb[m])).astype(np.int32)
        nc[~valid[blk]] = 0
        newcols[blk] = nc
    return ExchangePlan(send_idx=send_idx, cols=newcols, L=L,
                        ndev=ndev, n_local=nl)


def plan_pattern(cols: torch.Tensor, vals: torch.Tensor,
                 row0: int = 0) -> np.ndarray:
    """``cols`` on the host with every slot that stores a zero value
    pointed at its own row (``row0`` the first row's global index): the
    pattern an exchange plan is built from.  Such a slot adds ``0 · x``
    wherever it reads, so it needs no off-shard entry; a strictly lower
    operator then references only the shards before its own."""
    rows = torch.arange(row0, row0 + cols.shape[1], dtype=cols.dtype,
                        device=cols.device)
    return torch.where(vals != 0, cols, rows[None, :]).cpu().numpy()


def gathered_cols(cols: torch.Tensor, mesh: RowMesh,
                  npad: int) -> torch.Tensor:
    """Global columns as the all-gather route's kernel reads them: in one
    process the whole x itself; over ranks the gathered x as every local
    shard's exchange buffer, past the shard's own ``npad / ndev`` rows."""
    return cols + npad // mesh.ndev if mesh.over_ranks else cols


def remainder_recv(x: torch.Tensor, mesh: RowMesh, route: str,
                   send_idx: torch.Tensor | None, L: int):
    """The off-shard x a sharded remainder reads in one SpMV, and the
    route the kernel takes for it: the index-list exchange's buffer
    (``"exchange"``), or on the all-gather route over ranks the gathered x
    as every local shard's exchange buffer (:func:`gathered_cols`)."""
    nl = mesh.nlocal
    if route == "exchange":
        return (exchange_recv(x.view(nl, -1), send_idx, mesh) if L
                else None), route
    if route == "all_gather" and mesh.over_ranks:
        return mesh.gather_rows(x).expand(nl, -1).contiguous(), "exchange"
    return None, route


def shard_blocks(t: torch.Tensor, ndev: int) -> torch.Tensor:
    """``(K, ndev·npr)`` slot arrays as contiguous per-shard blocks
    ``(ndev, K, npr)``: the rows each shard owns, as its kernel reads
    them."""
    k, npad = t.shape
    return t.reshape(k, ndev, npad // ndev).transpose(0, 1).contiguous()


def exchange_recv(xs: torch.Tensor, send_idx: torch.Tensor,
                  mesh: RowMesh) -> torch.Tensor:
    """Gather every local shard's outgoing values (``xs``: ``(nlocal,
    npr)``, ``send_idx`` ``(nlocal, ndev, L)``) and swap them with every
    peer.  Returns ``(nlocal, ndev·L)``: each local shard's flat recv
    buffer, laid out as the remapped columns address it."""
    nl = mesh.nlocal
    sv = torch.gather(xs, 1, send_idx.view(nl, -1)).view(send_idx.shape)
    return mesh.all_to_all(sv).view(nl, -1)


@dataclass
class ExchangeELL:
    """A row-sharded ELL operator bound to its mesh: its SpMV moves only
    the off-shard x entries its columns reference (one ``all_to_all`` of
    the precomputed index lists), or, where the plan was refused, reads
    the whole x (``send_idx`` None: the all-gather route).

    ``cols`` holds the plan's remapped indices (into each shard's
    ``[x_local | recv]``) or the global columns
    (:func:`gathered_cols`), and ``vals`` the values, both as per-shard
    blocks ``(nlocal, K, npr)``; ``send_idx`` ``(nlocal, ndev, L)``
    int64.  ``ops.spmv`` dispatches here through the ``mesh`` attribute.
    """

    cols: torch.Tensor
    vals: torch.Tensor
    rownnz: torch.Tensor
    send_idx: torch.Tensor | None
    mesh: RowMesh
    L: int
    nrows: int
    ncols: int
    npad: int

    @property
    def k(self) -> int:
        return self.cols.shape[1]

    @property
    def route(self) -> str:
        """``"exchange"`` (index-list plan) or ``"all_gather"``."""
        return "all_gather" if self.send_idx is None else "exchange"

    def kernel_args(self, x: torch.Tensor):
        """The arguments of the one ``hyb_spmv_sharded`` launch of an SpMV
        of ``x`` (the exchange runs here): ``(args, kwargs)``."""
        x = x.contiguous()
        recv, route = remainder_recv(x, self.mesh, self.route,
                                     self.send_idx, self.L)
        return (None, gather.NO_LANES, x, self.mesh.nlocal), dict(
            cols=self.cols, vals=self.vals, recv=recv, route=route)

    def spmv(self, x: torch.Tensor) -> torch.Tensor:
        args, kw = self.kernel_args(x)
        return gather.hyb_spmv_sharded(*args, **kw)


def exchange_ell(ell, mesh: RowMesh) -> ExchangeELL:
    """Bind a sharded ELL (whole, npad a multiple of ``ndev``) to the
    mesh: the index-list exchange, built from its nonzero pattern (one
    host read of cols/vals/rownnz), or the all-gather route where that
    plan is refused.  Over ranks this rank's rows are kept."""
    ndev, nl = mesh.ndev, mesh.nlocal
    plan = build_exchange_plan(plan_pattern(ell.cols, ell.vals),
                               ell.rownnz.cpu().numpy(), ndev)
    lo, hi = mesh.local_rows(ell.npad)
    dev = ell.cols.device
    if plan is None:
        cols, send_idx, L = gathered_cols(ell.cols[:, lo:hi], mesh,
                                          ell.npad), None, 0
    else:
        mine = slice(mesh.first_shard, mesh.first_shard + nl)
        cols = torch.from_numpy(plan.cols[:, lo:hi]).to(dev)
        send_idx = torch.from_numpy(plan.send_idx[mine]).to(
            device=dev, dtype=torch.int64)
        L = plan.L
    return ExchangeELL(
        cols=shard_blocks(cols, nl), vals=shard_blocks(ell.vals[:, lo:hi], nl),
        rownnz=ell.rownnz[lo:hi], send_idx=send_idx, mesh=mesh, L=L,
        nrows=ell.nrows, ncols=ell.ncols, npad=hi - lo)
