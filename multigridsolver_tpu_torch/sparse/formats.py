"""Sparse matrix containers: host COO/CSR (numpy) and the device ELL.

* :class:`COO` — host-side interchange (0-based), numpy arrays.
* :class:`CSR` — host-side canonical compressed form used for conversions
  and scipy cross-checks, numpy arrays.
* :class:`ELL` — the device compute format, a dataclass of torch tensors.
  Storage is **slot-major**: ``cols``/``vals`` have shape ``(K, npad)``,
  so the row index is the contiguous axis and neighbouring threads of a
  kernel read neighbouring rows.  Rows are padded to a multiple of 1024;
  invalid slots hold ``col = 0, val = 0`` and are told apart from stored
  entries by the per-row counts ``rownnz`` (stored zeros are legal, so
  validity is never inferred from ``val != 0``).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from ..utils import timing


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclass
class COO:
    """Host-side coordinate format (0-based)."""

    row: np.ndarray  # (nnz,) int
    col: np.ndarray  # (nnz,) int
    val: np.ndarray  # (nnz,) float
    shape: tuple[int, int]

    @property
    def nnz(self) -> int:
        return int(self.row.shape[0])

    def to_csr(self) -> "CSR":
        """Sort by (row, col), merge duplicates by summation (MM semantics)."""
        n, m = self.shape
        order = np.lexsort((self.col, self.row))
        r, c, v = self.row[order], self.col[order], self.val[order]
        if len(r) > 0:
            key_changed = np.empty(len(r), dtype=bool)
            key_changed[0] = True
            key_changed[1:] = (r[1:] != r[:-1]) | (c[1:] != c[:-1])
            group = np.cumsum(key_changed) - 1
            nv = np.zeros(group[-1] + 1, dtype=v.dtype)
            np.add.at(nv, group, v)
            keep = np.flatnonzero(key_changed)
            r, c, v = r[keep], c[keep], nv
        indptr = np.zeros(n + 1, dtype=np.int64)
        np.add.at(indptr, r + 1, 1)
        indptr = np.cumsum(indptr)
        return CSR(indptr=indptr.astype(np.int64), indices=c.astype(np.int64),
                   data=v, shape=(n, m))


@dataclass
class CSR:
    """Host-side CSR with rows sorted by column (canonical)."""

    indptr: np.ndarray   # (n+1,)
    indices: np.ndarray  # (nnz,)
    data: np.ndarray     # (nnz,)
    shape: tuple[int, int]

    @property
    def nnz(self) -> int:
        return int(self.indices.shape[0])

    @property
    def nrows(self) -> int:
        return self.shape[0]

    @property
    def ncols(self) -> int:
        return self.shape[1]

    def rownnz(self) -> np.ndarray:
        return np.diff(self.indptr)

    def to_coo(self) -> COO:
        row = np.repeat(np.arange(self.nrows, dtype=np.int64), self.rownnz())
        return COO(row=row, col=self.indices.copy(), val=self.data.copy(),
                   shape=self.shape)

    def to_dense(self) -> np.ndarray:
        out = np.zeros(self.shape, dtype=self.data.dtype)
        coo = self.to_coo()
        np.add.at(out, (coo.row, coo.col), coo.val)
        return out

    def to_scipy(self):
        import scipy.sparse as sp
        return sp.csr_matrix((self.data, self.indices, self.indptr),
                             shape=self.shape)

    @staticmethod
    def from_scipy(m) -> "CSR":
        m = m.tocsr()
        m.sort_indices()
        return CSR(indptr=m.indptr.astype(np.int64),
                   indices=m.indices.astype(np.int64),
                   data=np.asarray(m.data), shape=m.shape)

    def to_ell(self, k: int | None = None, row_pad: int = 1024,
               dtype: torch.dtype = torch.float32,
               device: torch.device | str = "cuda",
               with_transpose: bool = False) -> "ELL":
        """Pack into the padded slot-major ELL on ``device`` (the card
        unless the caller asks for another device).

        ``k`` defaults to the max row degree; rows are padded to a multiple
        of ``row_pad`` (at least one block of ``row_pad`` rows).

        ``with_transpose``: pack the union of the stored patterns of A and
        Aᵀ (explicit zeros where only the transposed entry is stored) and
        attach the aligned transposed-value field ``vals_t``, so the
        nonsymmetric setup reads aⱼᵢ as a field instead of matching the
        transposed pattern.  A structurally symmetric input keeps its
        pattern.

        Spans (``utils/timing``): ``pack.union`` the union and transpose
        on the host, ``pack.scatter`` the fill of the slots,
        ``pack.copy`` the copy to ``device``."""
        if with_transpose:
            return self._union_ell(k, row_pad, dtype, device)
        with timing.span("pack.scatter"):
            n, m = self.shape
            counts = self.rownnz()
            kmax = int(counts.max()) if n > 0 and self.nnz > 0 else 1
            if k is None:
                k = max(kmax, 1)
            if kmax > k:
                raise ValueError(f"row degree {kmax} exceeds requested "
                                 f"width {k}")
            n_pad = max(_round_up(n, row_pad), row_pad)
            cols = np.zeros((k, n_pad), dtype=np.int32)
            vals = np.zeros((k, n_pad), dtype=np.float64)
            # slot index of each nnz within its row
            slot = np.arange(self.nnz, dtype=np.int64) - np.repeat(
                self.indptr[:-1], counts)
            rows = np.repeat(np.arange(n, dtype=np.int64), counts)
            cols[slot, rows] = self.indices
            vals[slot, rows] = self.data
            rownnz = np.zeros((n_pad,), dtype=np.int32)
            rownnz[:n] = counts
        with timing.span("pack.copy"):
            return ELL(cols=torch.from_numpy(cols).to(device),
                       vals=torch.from_numpy(vals).to(device=device,
                                                      dtype=dtype),
                       rownnz=torch.from_numpy(rownnz).to(device),
                       nrows=n, ncols=m)

    def _union_ell(self, k, row_pad, dtype, device) -> "ELL":
        with timing.span("pack.union"):
            fwd, bwd = self._union_csr()
        fell = fwd.to_ell(k=k, row_pad=row_pad, dtype=dtype, device=device)
        tell = bwd.to_ell(k=fell.k, row_pad=row_pad, dtype=dtype,
                          device=device)
        return dataclasses.replace(fell, vals_t=tell.vals)

    def _union_csr(self) -> tuple["CSR", "CSR"]:
        """A and the transposed-value field Aᵀ on the union of the stored
        patterns of A and Aᵀ (host)."""
        import scipy.sparse as sps
        a_sp = self.to_scipy().tocsr()
        a_sp.sort_indices()
        at_sp = a_sp.T.tocsr()
        at_sp.sort_indices()
        # the union of the STORED patterns (explicit zeros are stored
        # entries and stay aligned between the two fields), built with
        # ones so that scipy prunes nothing; both value fields are then
        # scattered onto the union positions by a sorted-key lookup
        pat = a_sp.copy()
        pat.data = np.ones_like(pat.data)
        patt = at_sp.copy()
        patt.data = np.ones_like(patt.data)
        u = (pat + patt).tocsr()
        u.sort_indices()
        n, m = u.shape
        key_u = (np.repeat(np.arange(n, dtype=np.int64), np.diff(u.indptr))
                 * m + u.indices.astype(np.int64))

        def fill(mtx):
            rows = np.repeat(np.arange(n, dtype=np.int64),
                             np.diff(mtx.indptr))
            key = rows * m + mtx.indices.astype(np.int64)
            out = np.zeros(u.nnz, dtype=mtx.data.dtype)
            out[np.searchsorted(key_u, key)] = mtx.data
            return out

        fwd = sps.csr_matrix((fill(a_sp), u.indices, u.indptr), shape=u.shape)
        bwd = sps.csr_matrix((fill(at_sp), u.indices, u.indptr),
                             shape=u.shape)
        return CSR.from_scipy(fwd), CSR.from_scipy(bwd)


@dataclass
class ELL:
    """Padded slot-major ELL matrix on one device.

    ``cols``/``vals``: ``(K, npad)``; slot ``s`` of row ``i`` is valid iff
    ``s < rownnz[i]``.  Invalid slots hold ``col = 0, val = 0`` so SpMV
    needs no masking.  ``nrows``/``ncols`` are the logical (unpadded)
    dimensions.  ``vals_t`` (optional) is the transposed-value field of the
    nonsymmetric setup path: ``vals_t[s, i] = A[cols[s, i], i]``.

    ``shard`` (optional) marks a row-sharded ELL as ``(mesh, npr, h)``:
    ``npad = mesh.ndev · npr`` rows in shards of ``npr``, each of which
    reads its own rows and ``h`` rows on either side (every stored column
    lies in that range).  Neighbour gathers then take the halo exchange
    and K4 (``parallel/dist_setup.shard_ell_halo`` sets it).  On a mesh
    over ranks the arrays hold this rank's ``mesh.nlocal · npr`` rows
    only, the first of them global row :attr:`row0`; column indices,
    ``nrows`` and ``ncols`` stay global.
    """

    cols: torch.Tensor    # (K, npad) int32
    vals: torch.Tensor    # (K, npad) float
    rownnz: torch.Tensor  # (npad,) int32
    nrows: int
    ncols: int
    vals_t: torch.Tensor | None = None
    shard: tuple | None = None

    @property
    def k(self) -> int:
        return self.cols.shape[0]

    @property
    def npad(self) -> int:
        return self.cols.shape[1]

    @property
    def device(self) -> torch.device:
        return self.cols.device

    @property
    def dtype(self) -> torch.dtype:
        return self.vals.dtype

    @property
    def nnz(self) -> int:
        return int(self.rownnz.sum())

    def slot_mask(self) -> torch.Tensor:
        """(K, npad) bool — True for valid (stored) slots."""
        sl = torch.arange(self.k, dtype=torch.int32, device=self.device)
        return sl[:, None] < self.rownnz[None, :]

    @property
    def row0(self) -> int:
        """The global index of the first stored row: 0 but on a rank's
        rows of a mesh over ranks."""
        if self.shard is None:
            return 0
        mesh, npr, _ = self.shard
        return mesh.first_shard * npr

    @property
    def global_npad(self) -> int:
        """The padded row count of the whole level: :attr:`npad` but on a
        rank's rows of a mesh over ranks, the same on every rank."""
        if self.shard is None:
            return self.npad
        mesh, npr, _ = self.shard
        return mesh.ndev * npr

    def row_ids(self) -> torch.Tensor:
        """(npad,) int32 — the global index of every stored row."""
        r0 = self.row0
        return torch.arange(r0, r0 + self.npad, dtype=torch.int32,
                            device=self.device)

    def row_iota(self) -> torch.Tensor:
        """(K, npad) int32 — the row index of every slot."""
        return self.row_ids()[None, :].expand(self.k, self.npad)

    def row_mask(self) -> torch.Tensor:
        """(npad,) bool — True for logical (unpadded) rows."""
        return self.row_ids() < self.nrows

    def to_csr(self) -> CSR:
        """Host-side conversion back to CSR (drops padding)."""
        cols = timing.read(self.cols[:, : self.nrows], array=True)
        vals = timing.read(self.vals[:, : self.nrows].double(), array=True)
        counts = timing.read(self.rownnz[: self.nrows],
                             array=True).astype(np.int64)
        k = cols.shape[0]
        valid_t = (np.arange(k)[:, None] < counts[None, :]).T   # (n, K)
        rows = np.repeat(np.arange(self.nrows, dtype=np.int64), counts)
        return COO(row=rows, col=cols.T[valid_t].astype(np.int64),
                   val=vals.T[valid_t],
                   shape=(self.nrows, self.ncols)).to_csr()
