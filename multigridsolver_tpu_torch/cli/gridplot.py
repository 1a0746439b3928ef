"""Aggregate visualisation for 2D grid problems.

The reference's ``gridPlot.cpp`` (recover the √n × √n grid from a
prolongation matrix, build the aggregate-adjacency graph and colour it
greedily so that touching aggregates differ) and ``plotMatrix.py`` (a
matplotlib image).  Writes the ``<name>grid_<tag>.mtx`` colour matrix
(1-based grid coordinates, the colour as the value, the reference's
interchange file) and, when asked, the PNG (which needs matplotlib).
Host work only: the grid is read from the files.
"""
from __future__ import annotations

import math

import numpy as np

from ..io import read_mtx, write_mtx
from ..setup.prolongation import labels_from_p_csr
from ..sparse.formats import COO


def aggregate_colors(labels: np.ndarray, adjacency_indptr, adjacency_indices
                     ) -> np.ndarray:
    """Greedy colouring of the aggregate-adjacency graph: aggregates in
    index order, each the first colour (from 1) none of its neighbours
    has."""
    n = labels.shape[0]
    nc = int(labels.max()) + 1 if (labels >= 0).any() else 0
    # aggregate adjacency: clusters touching via any fine edge
    neigh: list[set] = [set() for _ in range(nc)]
    for i in range(n):
        li = labels[i]
        if li < 0:
            continue
        for k in range(adjacency_indptr[i], adjacency_indptr[i + 1]):
            lj = labels[adjacency_indices[k]]
            if lj >= 0 and lj != li:
                neigh[li].add(lj)
    colors = np.full(nc, -1, dtype=np.int64)
    for c in range(nc):
        used = {colors[d] for d in neigh[c] if colors[d] >= 0}
        col = 1
        while col in used:
            col += 1
        colors[c] = col
    return colors


def grid_plot(matrix_path: str, p_path: str, out_png: str | None = None,
              out_mtx: str | None = None):
    """Colour the aggregates of the square-grid problem ``matrix_path``
    under the prolongation ``p_path``; returns (grid, colors)."""
    a = read_mtx(matrix_path)
    p = read_mtx(p_path)
    labels, nc = labels_from_p_csr(p)
    n = a.nrows
    side = int(round(math.sqrt(n)))
    if side * side != n:
        raise ValueError(f"matrix is not a square grid problem (n={n})")
    colors = aggregate_colors(labels, a.indptr, a.indices)
    node_color = np.where(labels >= 0, colors[np.maximum(labels, 0)], 0)
    grid = node_color.reshape(side, side)
    if out_mtx:
        ii, jj = np.meshgrid(np.arange(side), np.arange(side), indexing="ij")
        write_mtx(out_mtx, COO(row=ii.ravel(), col=jj.ravel(),
                               val=grid.ravel().astype(np.float64),
                               shape=(side, side)))
    if out_png:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        fig, ax = plt.subplots(figsize=(8, 8))
        im = ax.imshow(grid, cmap="tab20", interpolation="nearest")
        ax.set_title(f"aggregates: {nc} clusters, "
                     f"{int((labels < 0).sum())} excluded nodes")
        fig.colorbar(im, ax=ax, shrink=0.7)
        fig.savefig(out_png, dpi=120, bbox_inches="tight")
        plt.close(fig)
    return grid, colors
