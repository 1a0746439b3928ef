"""Matrix Market I/O.

The reference's file-interchange semantics: 1-based coordinate entries,
``%``-prefixed comment lines (the reference's own Poisson generator emits
a single-``%`` header), duplicates summed, rows canonically sorted, and
the ``symmetric`` qualifier expanded.  Files are parsed and written by
the C++ host runtime (:mod:`.native`); ``read_mtx(..., use_native=False)``
takes the pure-Python parser instead, which reads the same data (and
skips comment lines among the entries, which the C++ parser rejects).
"""
from __future__ import annotations

import io
import os

import numpy as np

from ..sparse.formats import COO, CSR


def read_mtx_coo(path: str | os.PathLike, use_native: bool = True) -> COO:
    """Read a Matrix Market coordinate file into host COO (0-based)."""
    if use_native:
        from .native import read_mtx_native
        return read_mtx_native(path)
    with open(path, "r") as f:
        header = f.readline()
        symmetric = "symmetric" in header
        # skip the remaining comment lines
        line = f.readline()
        while line.startswith("%") or line.strip() == "":
            line = f.readline()
        parts = line.split()
        nrows, ncols, nnz = int(parts[0]), int(parts[1]), int(parts[2])
        data = np.loadtxt(io.StringIO(f.read()), dtype=np.float64,
                          ndmin=2, comments="%")
    if data.size == 0:
        data = np.zeros((0, 3))
    if data.shape[0] != nnz:
        raise ValueError(
            f"{path}: header promises {nnz} entries, found {data.shape[0]}")
    row = data[:, 0].astype(np.int64) - 1
    col = data[:, 1].astype(np.int64) - 1
    val = data[:, 2] if data.shape[1] > 2 else np.ones(nnz)
    if symmetric:
        off = row != col
        row = np.concatenate([row, col[off]])
        col = np.concatenate([col, data[off, 0].astype(np.int64) - 1])
        val = np.concatenate([val, val[off]])
    return COO(row=row, col=col, val=val, shape=(nrows, ncols))


def read_mtx(path: str | os.PathLike, use_native: bool = True) -> CSR:
    """Read a Matrix Market file into canonical host CSR."""
    return read_mtx_coo(path, use_native=use_native).to_csr()


def write_mtx(path: str | os.PathLike, mat: CSR | COO) -> None:
    """Write CSR/COO as a ``general`` 1-based coordinate Matrix Market
    file with the C++ writer, one ``row col value`` entry a line, values
    as ``%.17g`` (enough digits to round-trip float64): the JAX package's
    bytes."""
    from .native import write_mtx_native
    write_mtx_native(path, mat.to_coo() if isinstance(mat, CSR) else mat)
