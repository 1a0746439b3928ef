"""Setup statistics and observability.

The Fortran ground truth prints setup diagnostics: pass counts, the
quality threshold, a histogram of the accepted pairs' quality (its
``save_trs`` accounting) and peak-memory counters.  Here:

* :func:`aggregate_quality_histogram`: the distribution of μ over the
  matched pairs (⌊μ⌋ buckets, like save_trs), and the singleton and
  excluded counts;
* :func:`setup_report`: the per-level coarsening table and the operator
  complexity;
* :func:`device_memory_report`: live, peak and total device memory from
  the CUDA caching allocator;
* :func:`trace`: a ``torch.profiler`` trace of a region, written as a
  Chrome trace.
"""
from __future__ import annotations

import os
from contextlib import contextmanager

import numpy as np
import torch

from ..sparse.formats import ELL


def aggregate_quality_histogram(a: ELL, labels, nbuckets: int = 10):
    """Histogram of the pair quality μ(i, j) over the matched pairs.

    Bucket k counts the pairs with ⌊μ⌋ == k (clamped to nbuckets − 1),
    μ read at the slot of the aggregate's second-smallest member in the
    row of its smallest; an aggregate of more than two nodes counts as a
    pair of those two.  Returns (hist, n_pairs, n_singletons,
    n_excluded)."""
    from ..setup.strength import compute_strength
    labels_np = torch.as_tensor(labels).cpu().numpy()[: a.nrows]
    st = compute_strength(a, ktg=float("inf"), first_pass=False)
    mu = st.mu.cpu().numpy()
    cols = a.cols.cpu().numpy()
    nnzr = a.rownnz.cpu().numpy()
    order = np.argsort(labels_np, kind="stable")
    ls = labels_np[order]
    starts = np.flatnonzero(np.concatenate([[True], ls[1:] != ls[:-1]]))
    sizes = np.diff(np.append(starts, len(ls)))
    real = ls[starts] >= 0
    n_single = int((real & (sizes == 1)).sum())
    # a stable sort keeps each aggregate's members in ascending order
    multi = starts[real & (sizes >= 2)]
    i, j = order[multi], order[multi + 1]
    hit = ((cols[:, i] == j[None, :])
           & (np.arange(a.k)[:, None] < nnzr[i][None, :]))
    mu_ij = mu[hit.argmax(0), i]
    ok = hit.any(0) & np.isfinite(mu_ij) & (mu_ij > 0)
    buckets = np.minimum(mu_ij[ok], nbuckets - 1).astype(np.int64)
    hist = np.bincount(buckets, minlength=nbuckets).astype(np.int64)
    n_excl = int((labels_np < 0).sum())
    return hist, len(multi), n_single, n_excl


def setup_report(setup) -> str:
    """Coarsening table and operator complexity of a SetupResult."""
    lines = ["level        n          nnz    ratio   nnz-ratio"]
    nnz0 = setup.matrices[0].nnz
    prev_n = None
    total_nnz = 0
    for l, m in enumerate(setup.matrices):
        nnz = m.nnz
        total_nnz += nnz
        ratio = f"{prev_n / m.nrows:.2f}" if prev_n else "  - "
        lines.append(f"{l:>5} {m.nrows:>10} {nnz:>12}   {ratio:>5}"
                     f"   {nnz / nnz0:>8.3f}")
        prev_n = m.nrows
    lines.append(f"operator complexity: {total_nnz / nnz0:.3f}")
    return "\n".join(lines)


def device_memory_report(device: torch.device | str = "cuda") -> dict:
    """Bytes in use, their peak, and the card's total memory on a CUDA
    ``device`` (the caching allocator's counters); empty for a device
    that keeps no such counters (the CPU)."""
    device = torch.device(device)
    if device.type != "cuda":
        return {}
    stats = torch.cuda.memory_stats(device)
    _, total = torch.cuda.mem_get_info(device)
    return {"bytes_in_use": stats.get("allocated_bytes.all.current", 0),
            "peak_bytes_in_use": stats.get("allocated_bytes.all.peak", 0),
            "bytes_limit": total}


@contextmanager
def trace(log_dir: str = "torch-trace"):
    """Profile a region with ``torch.profiler`` (the CPU, and the card
    when there is one) and write ``<log_dir>/trace.json``, a Chrome trace
    (chrome://tracing, Perfetto)."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield log_dir
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
