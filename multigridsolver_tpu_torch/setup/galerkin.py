"""Pairwise Galerkin coarse operator  Ac = Pᵀ A P.

After a pairwise pass every aggregate has at most two members (leader ℓ,
partner p — possibly ℓ = p), so coarse row c is the relabelled merge of
fine rows ℓ(c) and p(c): fetch both member rows (K3), sort each column's
2K candidates by coarse column, sum runs of equal columns and compact the
kept entries to the top slots.  No global nnz-sized sort is needed.

With the union field (``a.vals_t``) the transposed values are merged over
the same slot pattern, which gives Ac[J, I] at every coarse slot (I, J):
each coarse level inherits the field and never runs the lookup.

For any piecewise-constant P given as labels (aggregates of any size,
as an explicit P of the two-level preconditioner gives them),
:func:`galerkin_ell` relabels A's entries, sorts them by (row, col) and
sums each run of equal keys, folded in sorted order as the JAX package's
segment sum adds them on the CPU, so that Ac is the same to the bit.
"""
from __future__ import annotations

import torch

from ..sparse import ops as ell_ops
from ..sparse.formats import ELL
from ..utils import timing


def pair_members(paired: torch.Tensor, labels: torch.Tensor, nc: int):
    """Each coarse row's members at padded coarse size ``nc``: (real,
    safe_leader, partner_of, has_partner), each (nc,).  ``safe_leader``
    is 0 and ``partner_of`` the leader where a row is not ``real``."""
    dev = paired.device
    nodes = torch.arange(paired.shape[0], dtype=torch.int32, device=dev)
    active = labels >= 0
    # leader of each aggregate: its smaller member index
    lead = torch.minimum(nodes, torch.where(paired >= 0, paired, nodes))
    is_leader = active & (lead == nodes)
    # leaders are unique per aggregate; the others write into a dump slot.
    # Padding aggregates in [nc_true, nc) get no leader (-1) and produce
    # empty coarse rows.
    dump = torch.full((nc + 1,), -1, dtype=torch.int32, device=dev)
    dump.scatter_(0, torch.where(is_leader, labels, nc).long(),
                  torch.where(is_leader, nodes, -1))
    leader_of = dump[:nc]
    real = leader_of >= 0
    safe_leader = leader_of.clamp_min(0)
    partner_of = ell_ops.take_member_rows(safe_leader, paired[None, :])[0]
    partner_of = torch.where(real & (partner_of >= 0), partner_of,
                             safe_leader)
    return real, safe_leader, partner_of, real & (partner_of != safe_leader)


def galerkin_pair_arrays(a: ELL, paired: torch.Tensor, labels: torch.Tensor,
                         nc: int):
    """Coarse ELL arrays at padded coarse size ``nc``.

    Returns (cols, vals, rownnz, info, vals_t) with slot width 2K,
    info = [nnz_c, max_degree] (one device tensor) and the coarse
    transposed-value field (None without ``a.vals_t``)."""
    mesh = ell_ops.rank_mesh(a)
    if mesh is not None:
        return _galerkin_pair_arrays_ranks(a, paired, labels, nc, mesh)
    real, safe_leader, partner_of, has_partner = pair_members(paired, labels,
                                                              nc)
    return _pair_merge(_member_sources(a, labels), a.k, nc, real,
                       safe_leader, partner_of, has_partner)


def _member_sources(a: ELL, labels: torch.Tensor) -> list:
    """The member fields K3 fetches: the slot columns relabelled once on
    the fine side (K2, or K4 on a sharded ELL), the values, the row
    lengths and (with the union field) the transposed values."""
    lc_fine = ell_ops.take_neighbor(a, torch.where(labels >= 0, labels, -1)
                                    .to(torch.int32))
    sources = [lc_fine, a.vals, a.rownnz[None, :]]
    if a.vals_t is not None:
        sources.append(a.vals_t)
    return sources


def _pair_merge(sources, k: int, nc: int, real, safe_leader, partner_of,
                has_partner):
    """Merge each coarse row's two member rows of ``sources`` (columns
    ``nc`` and past are invalid): fetch them (one K3 launch per member
    set), sort each column's 2K candidates, sum runs of equal columns and
    compact the kept entries to the top slots.  Returns (cols, vals,
    rownnz, info, vals_t) over the rows of ``real``."""
    dev = real.device
    sl = torch.arange(k, dtype=torch.int32, device=dev)[:, None]
    union = len(sources) == 4

    def member_rows(members):
        # (K, m), (K, m), (1, m)[, (K, m)]
        cols_m, vals_m, nnz_m, *vt_m = ell_ops.take_member_rows_many(
            members, sources)
        nnz_m = nnz_m[0]
        ok = (sl < nnz_m[None, :]) & real[None, :] & (cols_m >= 0)
        return (torch.where(ok, cols_m, nc), torch.where(ok, vals_m, 0.0),
                torch.where(ok, vt_m[0], 0.0) if union else None)

    c1, v1, t1 = member_rows(safe_leader)
    c2, v2, t2 = member_rows(partner_of)
    c2 = torch.where(has_partner[None, :], c2, nc)     # mask duplicates
    v2 = torch.where(has_partner[None, :], v2, 0.0)
    cand_c = torch.cat([c1, c2], 0)                    # (2K, nc)
    cand_v = torch.cat([v1, v2], 0)
    # each column's 2K candidates by coarse column (invalid = nc last);
    # stable, so equal columns add in member order
    cand_c, order = torch.sort(cand_c, dim=0, stable=True)
    cand_v = torch.gather(cand_v, 0, order)
    # the transposed values ride along: sorted, merged and compacted by
    # the same permutations as the values
    payloads = [cand_v]
    if union:
        t2 = torch.where(has_partner[None, :], t2, 0.0)
        payloads.append(torch.gather(torch.cat([t1, t2], 0), 0, order))
    m2 = 2 * k
    # run-length sums of equal adjacent columns, accumulated from the end
    merged = []
    for cand in payloads:
        rows = [None] * m2
        rows[m2 - 1] = cand[m2 - 1]
        for s in range(m2 - 2, -1, -1):
            same = cand_c[s] == cand_c[s + 1]
            rows[s] = cand[s] + torch.where(same, rows[s + 1], 0.0)
        merged.append(torch.stack(rows))
    first = torch.ones_like(cand_c, dtype=torch.bool)
    first[1:] = cand_c[1:] != cand_c[:-1]
    keep = first & (cand_c < nc)
    pos = torch.cumsum(keep.to(torch.int32), 0, dtype=torch.int32) - 1
    rownnz = pos[-1] + 1
    # compact kept entries to the top slots (dropped entries sink below
    # every kept position with zeroed payloads: col 0 / val 0 padding)
    key = torch.where(keep, pos, m2)
    _, order = torch.sort(key, dim=0, stable=True)
    out_c = torch.gather(torch.where(keep, cand_c, 0), 0, order)
    out_v, *out_t = [torch.gather(torch.where(keep, m, 0.0), 0, order)
                     for m in merged]
    info = torch.stack([rownnz.sum(), rownnz.max()]).to(torch.int64)
    return (out_c.to(torch.int32), out_v, rownnz.to(torch.int32), info,
            out_t[0] if union else None)


def _galerkin_pair_arrays_ranks(a: ELL, paired: torch.Tensor,
                                labels: torch.Tensor, nc: int, mesh):
    """:func:`galerkin_pair_arrays` on a rank's rows of a mesh over ranks.

    Aggregates are numbered in leader order, so the coarse rows whose
    leader (the smaller member) lies on this rank form one range; the
    rank merges those rows.  A partner lies past the leader, at most the
    halo ``h`` into the next rank, whose first ``h`` rows of the member
    fields arrive through the row halo; where the halo would exceed a
    shard (``h`` None) the member fields are all-gathered whole.  One
    all-gather of every rank's rows (padded to the longest range) makes
    the arrays whole on every rank, the same bits as one process."""
    dev, r0, h = a.device, a.row0, a.shard[2]
    nodes = a.row_ids()
    active = labels >= 0
    lead = torch.minimum(nodes, torch.where(paired >= 0, paired, nodes))
    is_leader = active & (lead == nodes)
    counts = timing.read(mesh.rank_values(is_leader.sum()))
    first, width = sum(counts[:mesh.rank]), max(counts)
    dump = torch.full((width + 1,), -1, dtype=torch.int32, device=dev)
    dump.scatter_(0, torch.where(is_leader, labels - first, width).long(),
                  torch.where(is_leader, nodes - r0, -1))
    leader_of = dump[:width]
    real = leader_of >= 0
    safe_leader = leader_of.clamp_min(0)
    partner = ell_ops.take_member_rows(safe_leader, paired[None, :])[0]
    sources = []
    for src in _member_sources(a, labels):
        if h is None:
            sources.append(mesh.gather_rows(src))
            continue
        # the next rank's first h rows (each rank sends its own left)
        right = mesh.comm.exchange(src[:, :h], None)[1] if h else None
        sources.append(torch.cat([src, right if right is not None
                                  else torch.zeros_like(src[:, :h])], 1))
    # member rows of the sources: from this rank's first row, or global
    # where the sources are whole
    base = r0 if h is not None else 0
    safe_leader = safe_leader + (r0 - base)
    partner_of = torch.where(real & (partner >= 0), partner - base,
                             safe_leader)
    has_partner = real & (partner_of != safe_leader)
    out = _pair_merge(sources, a.k, nc, real, safe_leader, partner_of,
                      has_partner)
    whole = []
    for t in (out[0], out[1], out[2][None, :], out[4]):
        if t is None:
            whole.append(None)
            continue
        g = mesh.comm.all_gather(t).view(mesh.world, t.shape[0], width)
        rows = torch.cat([g[q, :, :counts[q]] for q in range(mesh.world)], 1)
        whole.append(torch.nn.functional.pad(rows, (0, nc - rows.shape[1])))
    cols, vals, rownnz, vals_t = whole
    rownnz = rownnz[0]
    info = torch.stack([rownnz.sum(), rownnz.max()]).to(torch.int64)
    return cols, vals, rownnz, info, vals_t


def galerkin_pair_ell(a: ELL, paired: torch.Tensor, labels: torch.Tensor,
                      nc_true: int, row_pad: int = 1024) -> tuple[ELL, int]:
    """Coarse ELL of one pairwise pass and its nnz (one host read of
    [nnz, max degree]; the slot axis is trimmed to the max degree)."""
    nc_pad = max(((nc_true + row_pad - 1) // row_pad) * row_pad, row_pad)
    cols, vals, rownnz, info, vals_t = galerkin_pair_arrays(a, paired,
                                                            labels, nc_pad)
    nnz_c, max_deg = timing.read(info)
    kc_eff = max(max_deg, 1)
    ell = ELL(cols=cols[:kc_eff].contiguous(),
              vals=vals[:kc_eff].contiguous(),
              rownnz=rownnz.clamp_max(kc_eff).to(torch.int32),
              nrows=nc_true, ncols=nc_true,
              vals_t=None if vals_t is None else vals_t[:kc_eff].contiguous())
    return ell, nnz_c


def coarse_coo(a: ELL, labels: torch.Tensor):
    """Relabelled COO triplets of Ac, unreduced, with their validity mask:
    (li, lj, v, valid), each (K · npad,) in slot-major order."""
    li = labels[None, :].expand(a.k, a.npad)
    lj = ell_ops.take_neighbor(a, labels)
    valid = a.slot_mask() & (li >= 0) & (lj >= 0)
    v = torch.where(valid, a.vals, 0.0)
    return li.reshape(-1), lj.reshape(-1), v.reshape(-1), valid.reshape(-1)


def galerkin_ell_arrays(a: ELL, labels: torch.Tensor, nc: int):
    """Coarse ELL arrays of Ac = PᵀAP at padded coarse size ``nc``, their
    slot width the longest coarse row.

    The relabelled entries are sorted stably by (row, col) (invalid ones
    last); each run of equal keys is one coarse entry, its value the fold
    of the run in sorted order from 0 (one elementwise add per position in
    the run, so the card adds in the same order as the CPU).  One host
    read (nnz, the longest row and the longest run).

    Returns (cols, vals, rownnz, [nnz_c, max_degree])."""
    li, lj, v, valid = coarse_coo(a, labels)
    m, dev = li.shape[0], a.device
    li = torch.where(valid, li, nc).long()
    lj = torch.where(valid, lj, nc).long()
    order = torch.sort(li * (nc + 1) + lj, stable=True).indices
    li, lj, v = li[order], lj[order], v[order]
    valid_s = li < nc
    newrun = valid_s.clone()
    newrun[1:] &= (li[1:] != li[:-1]) | (lj[1:] != lj[:-1])
    run_id = torch.cumsum(newrun, 0) - 1
    idx = torch.arange(m, device=dev)
    # each entry's offset in its run, each run's first entry and length
    start = torch.cummax(torch.where(newrun, idx, 0), 0).values
    offset = idx - start
    dump = torch.where(newrun, run_id, m)
    run_start = torch.full((m + 1,), m - 1, dtype=torch.long, device=dev)
    run_start.scatter_(0, dump, idx)
    last = valid_s.clone()
    last[:-1] &= ~valid_s[1:] | newrun[1:]
    run_len = torch.zeros((m + 1,), dtype=torch.long, device=dev)
    run_len.scatter_(0, torch.where(last, run_id, m), offset + 1)
    run_start, run_len = run_start[:m], run_len[:m]
    run_valid = run_len > 0
    rows_c = torch.where(run_valid, li[run_start], 0)
    cols_c = torch.where(run_valid, lj[run_start], 0)
    rownnz = ell_ops.bin_counts(torch.where(run_valid, rows_c, nc),
                                nc + 1)[:nc]
    nnz_c, max_deg, longest = timing.read(torch.stack(
        [newrun.sum(), rownnz.max(), run_len.max()]))
    kc = max(max_deg, 1)
    sums = torch.zeros((m,), dtype=v.dtype, device=dev)
    for p in range(longest):
        at = (run_start + p).clamp_max(m - 1)
        sums = torch.where(p < run_len, sums + v[at], sums)
    # each run's slot within its row: runs are sorted, so a row's runs are
    # consecutive and column-ordered
    row_start = torch.cumsum(rownnz, 0) - rownnz
    slot = idx - row_start[rows_c]
    flat = torch.where(run_valid, slot * nc + rows_c, kc * nc)
    cols = torch.zeros((kc * nc + 1,), dtype=torch.int32, device=dev)
    cols.scatter_(0, flat, cols_c.to(torch.int32))
    vals = torch.zeros((kc * nc + 1,), dtype=a.vals.dtype, device=dev)
    vals.scatter_(0, flat, sums)
    return (cols[:-1].view(kc, nc), vals[:-1].view(kc, nc),
            rownnz.to(torch.int32), [nnz_c, max_deg])


def galerkin_ell(a: ELL, labels: torch.Tensor, nc_true: int,
                 row_pad: int = 1024) -> ELL:
    """Ac = PᵀAP as an ELL for the piecewise-constant P of ``labels``
    (``nc_true`` aggregates), its slot axis the longest coarse row."""
    nc_pad = max(((nc_true + row_pad - 1) // row_pad) * row_pad, row_pad)
    cols, vals, rownnz, _ = galerkin_ell_arrays(a, labels, nc_pad)
    return ELL(cols=cols.contiguous(), vals=vals.contiguous(), rownnz=rownnz,
               nrows=nc_true, ncols=nc_true)
