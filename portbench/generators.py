"""The benchmark's own frozen copies of the input generators.

``poisson2d`` is the 5-point Laplacian of ``src/common/poisson.cpp:7-41``
(the reference's ``poisson`` generator): −1/4/−1 stencil on an n×n grid,
row-major, integer values.  ``csky3d`` is the 3D "CSky" skyscraper
convection-diffusion matrix (cell-centred finite volumes on the unit
cube, a coefficient field of towers 10³·(block + 1) where every block
index is even and 1 elsewhere, harmonic means on interior faces, the
field at the face centre on Dirichlet faces, upwind convection v = 1000
along every axis, rows scaled by h), vectorised with numpy.

Both return a scipy CSR with sorted column indices.  They are copies, not
imports: a later change to the program's generators does not change what
the benchmark measures.  A test holds them bitwise to the program's
generators at small grids (the program's csky3d also has a legacy
variant for the shipped n = 10 file, which this copy leaves out).
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp


def poisson2d(n: int) -> sp.csr_matrix:
    """5-point Laplacian on an n×n grid (n² unknowns)."""
    lap1 = sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(n, n))
    eye = sp.identity(n)
    m = (sp.kron(lap1, eye) + sp.kron(eye, lap1)).tocsr()
    m.sort_indices()
    return m


def _sky_field(coords: np.ndarray, tower: float = 1000.0,
               bands: int = 10) -> np.ndarray:
    """The coefficient field at points given as (..., 3) coordinates;
    tower heights follow the middle coordinate."""
    b = np.floor(bands * coords).astype(np.int64)
    all_even = np.all(b % 2 == 0, axis=-1)
    height = tower * (b[..., 1] + 1)
    return np.where(all_even, height, 1.0)


def csky3d(n: int, v: float = 1000.0, tower: float = 1000.0) -> sp.csr_matrix:
    """CSky3d on an n³ grid (n³ unknowns), nonsymmetric.

    Every diagonal entry sums its face terms in the order of a loop over
    axes 0, 1, 2, and along each axis the face below the cell, the face
    above it, then the boundary face, so the values are bitwise those of
    a node-by-node loop."""
    h = 1.0 / n
    conv = v * h * h          # v·h² (3D upwind term, matrix scaled by h)
    dif = h                   # diffusion faces carry a·h
    idx = np.arange(n)
    ii, jj, kk = np.meshgrid(idx, idx, idx, indexing="ij")
    centers = np.stack([(ii + 0.5) * h, (jj + 0.5) * h, (kk + 0.5) * h],
                       axis=-1)
    a = _sky_field(centers, tower)
    node = (ii * n + jj) * n + kk
    diag = np.zeros((n, n, n))
    rows, cols, vals = [], [], []
    face = (idx + 0.5) * h
    for axis, stride in ((0, n * n), (1, n), (2, 1)):
        lo = [slice(None)] * 3
        hi = [slice(None)] * 3
        lo[axis] = slice(0, n - 1)
        hi[axis] = slice(1, n)
        lo, hi = tuple(lo), tuple(hi)
        x, y = a[lo], a[hi]
        f = 2.0 * x * y / (x + y) * dif
        src = node[lo]
        rows += [src.ravel(), (src + stride).ravel()]
        cols += [(src + stride).ravel(), src.ravel()]
        vals += [(-f).ravel(), (-(f + conv)).ravel()]
        # the loop over faces reaches a cell's lower face (as its upper
        # neighbour) before its upper face
        diag[hi] += f + conv
        diag[lo] += f
        # boundary faces: the field at the face centre
        q, r = np.meshgrid(face, face, indexing="ij")
        pts0 = [q, r]
        pts0.insert(axis, np.zeros_like(q))
        pts1 = [q, r]
        pts1.insert(axis, np.ones_like(q))
        first = [slice(None)] * 3
        last = [slice(None)] * 3
        first[axis] = 0
        last[axis] = n - 1
        diag[tuple(first)] += _sky_field(np.stack(pts0, -1), tower) * dif \
            + conv
        diag[tuple(last)] += _sky_field(np.stack(pts1, -1), tower) * dif
    rows.append(node.ravel())
    cols.append(node.ravel())
    vals.append(diag.ravel())
    m = sp.csr_matrix((np.concatenate(vals),
                       (np.concatenate(rows), np.concatenate(cols))),
                      shape=(n ** 3, n ** 3))
    m.sort_indices()
    return m


GENERATORS = {"poisson2d": poisson2d, "csky3d": csky3d}


def generate(spec: dict) -> sp.csr_matrix:
    """The matrix a configuration's ``generator`` entry names:
    ``{"name": "poisson2d" | "csky3d", "grid": n}``."""
    return GENERATORS[spec["name"]](int(spec["grid"]))
