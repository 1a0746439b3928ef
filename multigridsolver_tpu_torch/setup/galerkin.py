"""Pairwise Galerkin coarse operator  Ac = Pᵀ A P.

After a pairwise pass every aggregate has at most two members (leader ℓ,
partner p — possibly ℓ = p), so coarse row c is the relabelled merge of
fine rows ℓ(c) and p(c): fetch both member rows (K3), sort each column's
2K candidates by coarse column, sum runs of equal columns and compact the
kept entries to the top slots.  No global nnz-sized sort is needed.
"""
from __future__ import annotations

import torch

from ..sparse import ops as ell_ops
from ..sparse.formats import ELL


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

    Returns (cols, vals, rownnz, info) with slot width 2K and
    info = [nnz_c, max_degree] (one device tensor)."""
    k, dev = a.k, a.device
    real, safe_leader, partner_of, has_partner = pair_members(paired, labels,
                                                              nc)
    # relabel the slot columns once on the fine side (K2), then fetch the
    # members' whole relabelled rows, values and row lengths (one K3
    # launch per member set)
    lc_fine = ell_ops.take_neighbor(a, torch.where(labels >= 0, labels, -1)
                                    .to(torch.int32))
    sl = torch.arange(k, dtype=torch.int32, device=dev)[:, None]

    def member_rows(members):
        # (K, nc), (K, nc), (1, nc)
        cols_m, vals_m, nnz_m = ell_ops.take_member_rows_many(
            members, [lc_fine, a.vals, a.rownnz[None, :]])
        nnz_m = nnz_m[0]
        ok = (sl < nnz_m[None, :]) & real[None, :] & (cols_m >= 0)
        return torch.where(ok, cols_m, nc), torch.where(ok, vals_m, 0.0)

    c1, v1 = member_rows(safe_leader)
    c2, v2 = member_rows(partner_of)
    c2 = torch.where(has_partner[None, :], c2, nc)     # mask duplicates
    v2 = torch.where(has_partner[None, :], v2, 0.0)
    cand_c = torch.cat([c1, c2], 0)                    # (2K, nc)
    cand_v = torch.cat([v1, v2], 0)
    # each column's 2K candidates by coarse column (invalid = nc last);
    # stable, so equal columns add in member order
    cand_c, order = torch.sort(cand_c, dim=0, stable=True)
    cand_v = torch.gather(cand_v, 0, order)
    m2 = 2 * k
    # run-length sums of equal adjacent columns, accumulated from the end
    merged_v = [None] * m2
    merged_v[m2 - 1] = cand_v[m2 - 1]
    for s in range(m2 - 2, -1, -1):
        same = cand_c[s] == cand_c[s + 1]
        merged_v[s] = cand_v[s] + torch.where(same, merged_v[s + 1], 0.0)
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
    out_v = torch.gather(torch.where(keep, torch.stack(merged_v), 0.0), 0,
                         order)
    info = torch.stack([rownnz.sum(), rownnz.max()]).to(torch.int64)
    return out_c.to(torch.int32), out_v, rownnz.to(torch.int32), info


def galerkin_pair_ell(a: ELL, paired: torch.Tensor, labels: torch.Tensor,
                      nc_true: int, row_pad: int = 1024) -> tuple[ELL, int]:
    """Coarse ELL of one pairwise pass and its nnz (one host read of
    [nnz, max degree]; the slot axis is trimmed to the max degree)."""
    nc_pad = max(((nc_true + row_pad - 1) // row_pad) * row_pad, row_pad)
    cols, vals, rownnz, info = galerkin_pair_arrays(a, paired, labels,
                                                    nc_pad)
    nnz_c, max_deg = (int(v) for v in info.tolist())
    kc_eff = max(max_deg, 1)
    ell = ELL(cols=cols[:kc_eff].contiguous(),
              vals=vals[:kc_eff].contiguous(),
              rownnz=rownnz.clamp_max(kc_eff).to(torch.int32),
              nrows=nc_true, ncols=nc_true)
    return ell, nnz_c
