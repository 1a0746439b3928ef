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
volume the plan is refused, and the caller keeps the all-gather.
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
    """A row-sharded ELL operator whose SpMV moves only the off-shard x
    entries its columns reference (one ``all_to_all`` of the precomputed
    index lists) instead of all-gathering x.

    ``cols`` holds the plan's remapped indices (into each shard's
    ``[x_local | recv]``) and ``vals`` the values, both as per-shard
    blocks ``(ndev, K, npr)``; ``send_idx`` ``(ndev, ndev, L)`` int64.
    ``ops.spmv`` dispatches here through the ``mesh`` attribute.
    """

    cols: torch.Tensor
    vals: torch.Tensor
    rownnz: torch.Tensor
    send_idx: torch.Tensor
    mesh: RowMesh
    L: int
    nrows: int
    ncols: int
    npad: int

    @property
    def k(self) -> int:
        return self.cols.shape[1]

    def spmv(self, x: torch.Tensor) -> torch.Tensor:
        nl = self.mesh.nlocal
        x = x.contiguous()
        recv = exchange_recv(x.view(nl, -1), self.send_idx,
                             self.mesh) if self.L > 0 else None
        return gather.hyb_spmv_sharded(None, gather.NO_LANES, x, nl,
                                       cols=self.cols, vals=self.vals,
                                       recv=recv, route="exchange")


def exchange_ell(ell, mesh: RowMesh) -> ExchangeELL | None:
    """Wrap a sharded ELL (whole, npad a multiple of ``ndev``) in the
    index-list exchange.  One host read of cols/rownnz; None if the plan
    is refused (the caller keeps the all-gather path).  Over ranks this
    rank's rows of the plan are kept."""
    ndev, nl = mesh.ndev, mesh.nlocal
    plan = build_exchange_plan(ell.cols.cpu().numpy(),
                               ell.rownnz.cpu().numpy(), ndev)
    if plan is None:
        return None
    lo, hi = mesh.local_rows(ell.npad)
    mine = slice(mesh.first_shard, mesh.first_shard + nl)
    dev = ell.cols.device
    return ExchangeELL(
        cols=shard_blocks(torch.from_numpy(plan.cols[:, lo:hi]).to(dev), nl),
        vals=shard_blocks(ell.vals[:, lo:hi], nl),
        rownnz=ell.rownnz[lo:hi],
        send_idx=torch.from_numpy(plan.send_idx[mine]).to(
            device=dev, dtype=torch.int64),
        mesh=mesh, L=plan.L, nrows=ell.nrows, ncols=ell.ncols,
        npad=hi - lo)
