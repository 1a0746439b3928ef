"""Distributed setup: aggregation over a row-sharded finest level.

The finest operator's rows are split over the mesh, and every neighbour
gather of its strength, matching, labelling and Galerkin relabelling
(``sparse/ops.take_neighbor``) runs as a halo exchange of ``h`` boundary
rows between mesh neighbours followed by K4, instead of a gather from the
whole of x.  Coarse levels and the Galerkin member fetch stay on K2/K3,
as the JAX package's stay on GSPMD's partitioned gathers.

Every decision of the setup is integer or bitwise-reproducible float
arithmetic evaluated pointwise, and the gathers move bits, so the sharded
setup yields the unsharded run's labels bit for bit.

On a mesh over ranks each rank holds only its rows of the finest level:
the halo's outer edges come from the neighbour ranks (or, where no
single-hop halo covers the columns, every gather reads the whole field,
all-gathered, on K2), the host reads of
the first pass (round flags, counts, the leader numbering) are
collective, each rank builds the coarse rows of its own leaders, and one
all-gather makes the first pass's coarse operator whole on every rank;
from the second pass on, the setup runs unchanged and identically on
every rank.  :func:`gather_setup` then makes the finest level whole again
for the hierarchy, and :func:`check_replicated` holds the replicated
levels of every rank to one another.
"""
from __future__ import annotations

import dataclasses
import hashlib

import numpy as np
import torch

from ..setup.aggregation import SetupResult, build_amg_setup
from ..solve.hierarchy import Hierarchy
from ..sparse.formats import ELL
from ..utils.config import HierarchyConfig
from .sharded import (RowMesh, _round_up, halo_reach, local_ell, on_device,
                      repad_ell, shard_ell)

# halo widths are whole multiples of this many rows
HALO_MULTIPLE = 128
# shards hold whole row blocks of the single-card layout
ROW_BLOCK = 1024


def shard_ell_halo(a: ELL, mesh: RowMesh) -> ELL | None:
    """Row-shard ``a`` for the K4 neighbour gathers.

    Repads to ``npad`` a multiple of ``ndev · 1024`` (npr = npad / ndev
    rows per shard; the new rows are empty), and takes the halo width
    ``h`` from the stored columns: how far any shard's valid columns reach
    before its first row or past its last, rounded up to a multiple of
    128.  A shard's own rows lie inside its covered range by construction,
    so every index ``take_neighbor`` is given (stored columns, own rows) is
    served.  Marks the ELL with ``shard = (mesh, npr, h)``; returns None
    when the halo would exceed a shard (no single-hop exchange covers it).
    Over ranks ``a`` is whole on every rank, the halo also covers the
    rows that store a column of a shard (a column sum's terms), and only
    this rank's rows are kept.
    """
    ndev = mesh.ndev
    a = on_device(repad_ell(a, ndev * ROW_BLOCK), mesh.device)
    npr = a.npad // ndev
    h = _round_up(halo_reach(a, ndev, transposed=mesh.over_ranks),
                  HALO_MULTIPLE)
    if h > npr:
        return None
    if mesh.over_ranks:
        return local_ell(a, mesh, h)
    return dataclasses.replace(a, shard=(mesh, npr, h))


def build_amg_setup_sharded(a: ELL, cfg: HierarchyConfig,
                            mesh: RowMesh) -> SetupResult:
    """The multilevel aggregation setup with the finest level row-sharded
    over ``mesh``: its neighbour gathers ride the halo exchange and K4
    (``shard_ell_halo``), or, when no single-hop halo covers it, the
    gathers from the whole vector.  The rest is ``build_amg_setup``
    unchanged.  The labels equal the unsharded run's on the logical rows;
    the finest level's are padded with -1 to the sharded npad.

    Over ranks ``a`` is the whole operator on every rank; the finest
    level's operator and labels in the result are this rank's rows (every
    other level is whole).  The mutual matching runs over ranks, with
    checktentagg too: its checked passes test the merges in the round's
    input, the finest level's rows on each rank, summing the merges whose
    members lie on several ranks (``setup/tentagg.py``).  Two options
    are refused there: the greedy matching copies the whole finest
    level (its CSR and exclusions) to the host, which no rank holds, and
    ``smooth_p``'s SpGEMM reads host sizes of the finest product, which
    the JAX package's own run across processes has not shown to work.
    A halo wider than a shard over ranks makes every gather of the finest
    level read the whole field, all-gathered once per gather (K2 on the
    gathered vector), and every host read stays an all-reduced scalar, so
    that all ranks branch alike."""
    if mesh.over_ranks:
        agg = cfg.aggregation
        refused = [why for why, on in (
            ("the greedy matching (it reads the whole finest level on the "
             "host: its CSR and exclusions)", agg.matching == "greedy"),
            ("smooth_p (its SpGEMM reads host sizes of the finest product; "
             "no run across processes has shown that path)",
             cfg.smooth_p is not None)) if on]
        if refused:
            raise NotImplementedError(
                f"the setup over ranks does not take {'; '.join(refused)}")
    a_sh = shard_ell_halo(a, mesh)
    if a_sh is None and mesh.over_ranks:
        a_sh = local_ell(on_device(repad_ell(a, mesh.ndev * ROW_BLOCK),
                                   mesh.device), mesh, None)
    elif a_sh is None:
        a_sh = shard_ell(a, mesh)
    return build_amg_setup(a_sh, cfg)


def gather_setup(setup: SetupResult, a: ELL, mesh: RowMesh) -> SetupResult:
    """A setup of :func:`build_amg_setup_sharded` over ranks with its
    finest level whole on every rank: ``a`` (the whole operator every rank
    holds, as it was passed) and the finest labels all-gathered (a
    collective); the other levels are whole already.  Unchanged in one
    process."""
    if not mesh.over_ranks:
        return setup
    labels = mesh.all_gather(setup.level_labels[0].view(mesh.nlocal, -1))
    return dataclasses.replace(
        setup, matrices=[a] + list(setup.matrices[1:]),
        level_labels=[labels[:a.npad].to(a.device)]
        + list(setup.level_labels[1:]))


def replicated_digest(hier: Hierarchy, shard_levels: int) -> str:
    """SHA-256 of everything a sharded hierarchy replicates: the levels
    from ``shard_levels`` on (operator, labels, smoother state: diagonal,
    λmax, gs2's triangular halves, ilu0's factors and U diagonal;
    transfer arrays) and the coarse LU."""
    h = hashlib.sha256()

    def add(t):
        if t is None:
            h.update(b"-")
        elif torch.is_tensor(t):
            h.update(str((t.dtype, tuple(t.shape))).encode())
            h.update(t.detach().cpu().reshape(-1).view(torch.uint8)
                     .numpy().tobytes())
        else:
            h.update(repr(t).encode())

    def add_op(a):
        if a is None:
            add(None)
        elif isinstance(a, ELL):
            for t in (a.cols, a.vals, a.rownnz, a.nrows):
                add(t)
        else:
            for t in (a.dvals, a.offsets, a.nrows):
                add(t)
            add_op(a.ell)

    for lvl in hier.levels[shard_levels:]:
        sm = lvl.smoother
        add_op(lvl.a)
        for t in (lvl.labels, sm.d, sm.lmax, sm.udiag):
            add(t)
        for op in (sm.lower, sm.upper, sm.lmat, sm.umat):
            add_op(op)
        for t in (lvl.tplan.p_cols, lvl.tplan.m_cols, lvl.tplan.m_vals):
            add(t)
    for t in (hier.coarse.lu, hier.coarse.piv):
        add(t)
    return h.hexdigest()


def check_replicated(hier: Hierarchy, mesh: RowMesh,
                     shard_levels: int) -> str:
    """All-gather every rank's :func:`replicated_digest` and raise unless
    they agree (a collective).  Returns the digest."""
    digest = replicated_digest(hier, shard_levels)
    if mesh.over_ranks:
        mine = torch.from_numpy(np.frombuffer(bytes.fromhex(digest),
                                              dtype=np.int64).copy())
        every = mesh.all_gather(mine.to(mesh.device).view(1, -1)) \
            .view(mesh.world, -1).cpu()
        differ = [r for r in range(mesh.world)
                  if not torch.equal(every[r], mine)]
        if differ:
            raise RuntimeError(f"rank {mesh.rank}: the replicated levels "
                               f"differ from ranks {differ}")
    return digest
