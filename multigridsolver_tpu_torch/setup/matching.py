"""Pairwise matching — iterative mutual-best handshake.

round:  every unmatched node proposes to its best available allowed
        neighbour (minimal μ, ties broken by a hashed canonical edge key
        that both endpoints compute identically);
accept: proposals that are mutual (i→j and j→i) become pairs;
repeat until a round accepts nothing; leftovers become singletons.

μ(i,j) is bitwise symmetric (strength.py) and the tie-break key is a
function of the unordered edge, so the result is deterministic.  The loop
reads one flag per round from the device.  On a rank's rows of a mesh
over ranks (``a.shard``) node indices are global, the neighbour fields
come in through the halo (K4), and the host reads are collective: the
round flag is an all-reduced max, the counts all-reduced sums, and the
leader numbering continues the ranks before (an exclusive prefix of
their leader counts), so the labels are those of one process.

The reference CPU algorithm, an exact sequential greedy matching in CMK
priority order, runs on the host: in C++ (``io/native.py``) on the setup
path, and here as its numpy twins (:func:`greedy_match_host`,
:func:`cmk_order_host`, :func:`cmk_order_genuine_host`).
"""
from __future__ import annotations

import numpy as np
import torch

from ..sparse import ops
from ..sparse.formats import ELL
from ..utils import timing
from .strength import StrengthData

_M32 = 0xFFFFFFFF


def _mul32(h: torch.Tensor, c: int) -> torch.Tensor:
    """(h · c) mod 2³² for int64 ``h`` in [0, 2³²): the product is split
    at 16 bits of ``c`` so no intermediate leaves int64."""
    lo = h * (c & 0xFFFF)
    hi = ((h * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _edge_hash(a: ELL) -> torch.Tensor:
    """Per-slot canonical edge hash, identical from both endpoints: the
    uint32 multiply-xorshift of ``min(i,j)·2654435761 + max(i,j)``, kept
    to 31 bits, as int32."""
    ri = a.row_iota().to(torch.int64)
    cols = a.cols.to(torch.int64)
    lo = torch.minimum(ri, cols)
    hi = torch.maximum(ri, cols)
    h = (_mul32(lo, 2654435761) + hi) & _M32
    h = _mul32(h ^ (h >> 16), 0x7FEB352D)
    h = _mul32(h ^ (h >> 15), 0x846CA68B)
    h = h ^ (h >> 16)
    return (h & 0x7FFFFFFF).to(torch.int32)


def _best_neighbor(a: ELL, mu: torch.Tensor, allowed: torch.Tensor,
                   available: torch.Tensor,
                   ehash: torch.Tensor) -> torch.Tensor:
    """Per-node best available allowed neighbour by (μ, edge key, column);
    (npad,) int32 partner or -1."""
    cand = allowed & ops.take_neighbor(a, available) & available[None, :]
    mu_c = torch.where(cand, mu, torch.inf)
    best_mu = mu_c.amin(0, keepdim=True)
    imax = torch.iinfo(torch.int32).max
    tie = cand & (mu_c == best_mu)
    ekey = torch.where(tie, ehash, imax)
    best_ekey = ekey.amin(0, keepdim=True)
    pcand = torch.where(ekey == best_ekey, a.cols, imax)
    partner = pcand.amin(0)
    has = tie.any(0)
    return torch.where(has, partner, -1).to(torch.int32)


def mutual_match(a: ELL, strength: StrengthData,
                 max_rounds: int = 64,
                 skipass_frac: float = 0.0) -> torch.Tensor:
    """Run the handshake matching.

    Returns ``paired`` (npad,) int32: partner index for matched nodes,
    own index for singletons, -1 for excluded nodes.

    ``skipass_frac`` > 0: when the excluded rows reach ``skipass_frac`` ·
    n, no pair is formed and every other row is a singleton (the
    Fortran's skipass heuristic)."""
    nodes = a.row_ids()
    undecided = ~strength.excluded
    skip = None
    if skipass_frac > 0.0:
        rows = a.row_mask()
        n_excl = ops.all_sum(a, (strength.excluded & rows).sum())
        skip = n_excl >= skipass_frac * ops.all_sum(a, rows.sum()) \
            .clamp_min(1)
        undecided = undecided & ~skip
    ehash = _edge_hash(a)
    paired = torch.full((a.npad,), -1, dtype=torch.int32, device=a.device)
    avail = undecided
    for _ in range(max_rounds):
        prop = _best_neighbor(a, strength.mu, strength.allowed, avail,
                              ehash)
        prop_of_prop = ops.take_neighbor(a, prop, idx=prop.clamp_min(0))
        mutual = (prop >= 0) & (prop_of_prop == nodes)
        accepted = mutual & avail
        paired = torch.where(accepted, prop, paired)
        avail = avail & ~mutual
        if not ops.all_any(a, accepted):
            break
    # leftovers (still available, not excluded) become singletons
    paired = torch.where(avail & undecided, nodes, paired)
    if skip is not None:
        paired = torch.where(skip & ~strength.excluded, nodes, paired)
    return torch.where(strength.excluded, -1, paired).to(torch.int32)


def labels_from_pairs(paired: torch.Tensor, excluded: torch.Tensor,
                      a: ELL) -> tuple[torch.Tensor, int]:
    """Number aggregates by leader order (the leader is the smaller index
    of a pair) and label nodes.  Returns (labels, nc): labels[i] = -1 for
    excluded nodes, nc read back to the host."""
    nodes = a.row_ids()
    active = (paired >= 0) & ~excluded
    leader = active & (paired >= nodes)
    mesh = ops.rank_mesh(a)
    first = 0
    if mesh is not None:
        counts = mesh.rank_values(leader.sum())
        first = counts[:mesh.rank].sum()
        nc = timing.read(counts.sum())
    agg_of_leader = (torch.cumsum(leader.to(torch.int32), 0) - 1 + first) \
        .to(torch.int32)
    # a follower takes its partner's (the leader's) aggregate id
    agg_of_partner = ops.take_neighbor(a, agg_of_leader,
                                       idx=paired.clamp_min(0))
    labels = torch.where(leader, agg_of_leader, agg_of_partner)
    labels = torch.where(active, labels, -1).to(torch.int32)
    return labels, nc if mesh is not None else timing.read(leader.sum())


def greedy_match_host(a_csr, ktg: float, first_pass_excluded: np.ndarray,
                      si: np.ndarray, order: np.ndarray | None = None
                      ) -> np.ndarray:
    """Exact sequential greedy matching (numpy, float64) in the given
    priority order: every node in turn takes its available neighbour of
    least μ in (0, ktg] that passes aᵢᵢ − sᵢ + aⱼⱼ − sⱼ ≥ 0, or stays a
    singleton.  ``a_csr``: host CSR.  Returns labels (n,) int32 (−1 =
    excluded)."""
    n = a_csr.nrows
    indptr, indices, data = a_csr.indptr, a_csr.indices, a_csr.data
    dense_diag = np.zeros(n)
    for i in range(n):
        for k in range(indptr[i], indptr[i + 1]):
            if indices[k] == i:
                dense_diag[i] = data[k]

    def coeff(i, j):
        lo, hi = indptr[i], indptr[i + 1]
        pos = np.searchsorted(indices[lo:hi], j)
        if pos < hi - lo and indices[lo + pos] == j:
            return data[lo + pos]
        return 0.0

    if order is None:
        order = cmk_order_host(a_csr)
    in_u = ~first_pass_excluded.astype(bool).copy()
    labels = np.full(n, -1, np.int32)
    nc = 0
    for i in order:
        if not in_u[i]:
            continue
        best_j, best_mu = -1, np.inf
        for k in range(indptr[i], indptr[i + 1]):
            j = indices[k]
            if j == i or not in_u[j]:
                continue
            aij = data[k]
            if aij == 0.0:
                continue
            aii, ajj = dense_diag[i], dense_diag[j]
            if aii - si[i] + ajj - si[j] < 0:
                continue
            aji = coeff(j, i)
            with np.errstate(divide="ignore", invalid="ignore"):
                num = 2.0 / (1.0 / aii + 1.0 / ajj)
                den = (-(aij + aji) / 2.0
                       + 1.0 / (1.0 / (aii - si[i]) + 1.0 / (ajj - si[j])))
                mu = num / den
            if mu > 0.0 and mu < best_mu:
                best_j, best_mu = j, mu
        if best_j != -1 and best_mu <= ktg:
            labels[i] = nc
            labels[best_j] = nc
            in_u[i] = in_u[best_j] = False
        else:
            labels[i] = nc
            in_u[i] = False
        nc += 1
    return labels


def cmk_order_host(a_csr) -> np.ndarray:
    """BFS visitation order from node 0, the reference's simplified "CMK"
    (no degree sort, no reversal); unreached nodes restart the search, so
    the order covers every node where the reference asserts
    connectivity."""
    n = a_csr.nrows
    indptr, indices = a_csr.indptr, a_csr.indices
    visited = np.zeros(n, dtype=bool)
    order = np.empty(n, dtype=np.int64)
    cnt = 0
    for start in range(n):
        if visited[start]:
            continue
        visited[start] = True
        order[cnt] = start
        cnt += 1
        head = cnt - 1
        while head < cnt:
            u = order[head]
            head += 1
            for k in range(indptr[u], indptr[u + 1]):
                v = indices[k]
                if not visited[v]:
                    visited[v] = True
                    order[cnt] = v
                    cnt += 1
    return order


def cmk_order_genuine_host(a_csr) -> np.ndarray:
    """Genuine Cuthill-McKee, the Fortran's rule: degree-1 nodes first
    (index order), minimum-degree start, each BFS front's new neighbours
    appended in ascending-degree (stable) order, reducible restarts from
    the next unnumbered node of progressively relaxed minimal degree.  No
    reversal: AGMG uses plain CMK."""
    n = a_csr.nrows
    indptr, indices = a_csr.indptr, a_csr.indices
    deg = np.diff(indptr)
    order = np.empty(n, dtype=np.int64)
    numbered = np.zeros(n, dtype=bool)
    ones = np.flatnonzero(deg <= 1)
    order[: len(ones)] = ones
    numbered[ones] = True
    i2 = len(ones)
    if i2 >= n:
        return order
    rest = np.flatnonzero(deg > 1)
    jj = rest[np.argmin(deg[rest])]
    mindg = deg[jj]
    ijs = -1
    while True:
        order[i2] = jj
        numbered[jj] = True
        i2 += 1
        i1 = i2 - 1
        while i1 < i2 and i2 < n:
            u = order[i1]
            nbrs = indices[indptr[u]: indptr[u + 1]]
            new = [v for v in nbrs if v != u and not numbered[v]]
            new.sort(key=lambda v: deg[v])        # stable ascending degree
            for v in new:
                order[i2] = v
                numbered[v] = True
                i2 += 1
            i1 += 1
        if i2 >= n:
            return order
        jj = -1
        while jj < 0:
            ijs += 1
            if ijs >= n:
                mindg += 1
                ijs = 0
            if not numbered[ijs] and deg[ijs] == mindg:
                jj = ijs
