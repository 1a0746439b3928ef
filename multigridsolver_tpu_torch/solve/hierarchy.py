"""Multigrid hierarchy and cycles.

Keep coarsening until the coarsest operator is small enough to factor
densely, smooth the intermediate levels, and traverse with V- or K-cycles
(Notay's K-cycle: the recursive correction is accelerated by two steps of
flexible CG on the finest ``kcycle_depth`` levels).  At each level the
coarse correction and the smoother combine multiplicatively, c + S(b − A
c) (or with pre-smoothing), or additively, c + S(b): both act on b and
the results are summed.  A two-level hierarchy with pre 0 and post 1 is
the reference's own two-level preconditioner.

Each level's operator is the DIA+ELL hybrid (solve-phase SpMV), its
transfers the K1 arrays of ``setup/transfers.py``.  The coarsest level is
a dense LU at tight padding (``torch.linalg.lu_factor``/``lu_solve``).

On the card a hierarchy replays its cycle as one CUDA graph
(:meth:`Hierarchy.precondition`): the cycle reads nothing back to the
host, so its few thousand small launches can be captured once and
replayed for every right-hand side.
"""
from __future__ import annotations

import gc
from dataclasses import dataclass, field

import torch

from ..setup import transfers as tf
from ..sparse import hybrid as hyb
from ..sparse import ops
from ..sparse.formats import ELL
from ..utils import timing
from .smoothers import Smoother, make_smoother


@dataclass
class Level:
    """One grid level: its operator, the fine→coarse labels defining P
    ((npad,) int32, −1 for nodes outside the coarse space), the smoother
    state (which for ``ilu0`` holds the factors of the level's ELL, and
    for ``gs2`` the operator's strictly triangular parts) and the transfer
    arrays.  The operator is a HYB, or on a row-sharded level a
    ``parallel.HaloOp`` (a HYB bound to its mesh, which reads as that HYB
    everywhere but in ``ops.spmv``); a sharded level's smoother state is
    bound to the mesh the same way (``parallel.shard_hierarchy``)."""

    a: hyb.HYB
    labels: torch.Tensor
    smoother: Smoother
    tplan: tf.TransferPlan
    nc_pad: int


@dataclass
class CoarseSolve:
    """Dense LU of the coarsest operator at tight padding ``m`` (logical
    size rounded up to 8); padding and empty rows carry an identity block
    so the factorisation is well-posed."""

    a: ELL
    lu: torch.Tensor
    piv: torch.Tensor
    m: int

    def solve(self, b: torch.Tensor) -> torch.Tensor:
        with timing.span("coarse_solve"):
            xm = torch.linalg.lu_solve(self.lu, self.piv,
                                       b[: self.m, None])[:, 0]
            if b.shape[0] == self.m:
                return xm
            out = torch.zeros_like(b)
            out[: self.m] = xm
            return out


def make_coarse_solve(a: ELL) -> CoarseSolve:
    m = min(max((a.nrows + 7) // 8 * 8, 8), a.npad)
    dense = ops.to_dense(a)
    full = torch.zeros((m, m), dtype=a.vals.dtype, device=a.device)
    w = min(a.ncols, m)
    full[: a.nrows, :w] = dense[:, :w]
    # identity on padding (and on empty rows, e.g. excluded G0 rows)
    empty = (full == 0.0).all(1)
    full = full + torch.diag(empty.to(full.dtype))
    lu, piv, info = torch.linalg.lu_factor_ex(full)
    info = timing.read(info)
    if info:
        raise torch.linalg.LinAlgError(
            f"the coarsest operator is singular (U[{info - 1}, {info - 1}] "
            f"is zero)")
    return CoarseSolve(a=a, lu=lu, piv=piv, m=m)


COMBINATIONS = ("multiplicative", "additive")


@dataclass
class Hierarchy:
    """The levels, the coarsest level's LU and how they are traversed:
    ``cycle`` (``vcycle`` or ``kcycle``), the pre- and post-smoothing
    counts, the K-cycle's inner steps and depth, and ``combination``, how
    the coarse correction and the smoother combine at each level
    (``multiplicative``: c + S(b − A c), or pre-smoothing first;
    ``additive``: c + S(b), which ignores the smoothing counts)."""

    levels: tuple[Level, ...]
    coarse: CoarseSolve
    cycle: str = "vcycle"        # vcycle | kcycle
    pre_smooth: int = 0
    post_smooth: int = 1
    kcycle_steps: int = 2
    # inner-Krylov acceleration only on the finest kcycle_depth levels
    kcycle_depth: int = 3
    combination: str = "multiplicative"

    # the captured cycle of precondition; a copy (dataclasses.replace,
    # shard_hierarchy) starts without one
    _graph: "CycleGraph | None" = field(default=None, init=False,
                                        repr=False, compare=False)

    @property
    def nlevels(self) -> int:
        return len(self.levels) + 1

    def precondition(self, b: torch.Tensor) -> torch.Tensor:
        """One multigrid cycle as M⁻¹ b (zero initial guess).

        For ``b`` on a CUDA device the cycle becomes a CUDA graph: the
        first such call runs eagerly (it warms lazy state: the kernels'
        library, cuBLAS, the allocator), the second captures the cycle
        for ``b``'s shape, dtype and device and replays it, and every
        later call with that shape, dtype and device copies ``b`` into the
        graph's input, replays, and returns a copy of its output (a new
        tensor each call: BiCGStab keeps one result across the next
        call).  Every other call runs eagerly: on the CPU, with another
        shape, dtype or device, and on a hierarchy with a level bound to
        a row mesh (``parallel.shard_hierarchy``), whose K-cycle
        all-reduces over ranks.  The replay is the eager cycle's kernels
        on the same operators, so its result is the same bits; the graph
        holds the level tensors it was captured on, so a level is
        changed on a copy (``dataclasses.replace``), never in place.
        Counters ``kcycle.eager``, ``kcycle.capture`` and
        ``kcycle.replay`` count the calls by kind; ``level``, ``smooth``
        and ``coarse_solve`` spans (and the smoothers' counters) appear
        only where the cycle's Python runs (eager and capturing calls)."""
        with timing.span("precondition"):
            graph = self._graph
            if graph is not None and graph.takes(b):
                if graph.graph is None:
                    graph.capture(self, b)
                    timing.count("kcycle.capture")
                else:
                    timing.count("kcycle.replay")
                return graph.replay(b)
            if graph is None and b.is_cuda and not _bound_to_mesh(self):
                # the first call on the card runs eagerly and keys the graph
                self._graph = CycleGraph(b)
            timing.count("kcycle.eager")
            return _cycle(self, 0, b)

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        if self.levels:
            return ops.spmv(self.levels[0].a, x)
        return ops.spmv(self.coarse.a, x)

    @property
    def mesh(self):
        """The row mesh over ranks the finest level is split across, or
        None (one process: its vectors are whole)."""
        mesh = getattr(self.levels[0].a, "mesh", None) if self.levels \
            else None
        return mesh if mesh is not None and mesh.over_ranks else None


def _bound_to_mesh(hier: Hierarchy) -> bool:
    """Whether a level's operator or transfers are bound to a row mesh
    (``parallel.HaloOp``, ``ExchangeELL``, ``RankTransfer``)."""
    return any(hasattr(level.a, "mesh") or hasattr(level.tplan, "mesh")
               for level in hier.levels)


class CycleGraph:
    """A hierarchy's cycle as one CUDA graph for right-hand sides of one
    shape, dtype and device: before :meth:`capture` only that key (the
    first call ran eagerly), after it the graph, its static input ``b``
    and its output ``x`` (which lies in the graph's private memory pool,
    freed with the graph)."""

    def __init__(self, b: torch.Tensor):
        self.key = (b.shape, b.dtype, b.device)
        self.graph: torch.cuda.CUDAGraph | None = None
        self.b = self.x = None

    def takes(self, b: torch.Tensor) -> bool:
        return (b.shape, b.dtype, b.device) == self.key

    def capture(self, hier: Hierarchy, b: torch.Tensor) -> None:
        """Capture ``_cycle(hier, 0, ·)`` on a static copy of ``b``.

        Python's cyclic collector is held off during the capture: a
        dropped hierarchy that sits in a reference cycle (one whose
        ``precondition`` was replaced by a wrapper around its own bound
        method, say) is freed whenever the collector runs, and its graph
        freed in the middle of this capture invalidates the capture."""
        static = b.clone()
        graph = torch.cuda.CUDAGraph()
        collecting = gc.isenabled()
        gc.disable()
        try:
            with timing.span("kcycle.capture"), \
                    torch.cuda.device(b.device), torch.cuda.graph(graph):
                x = _cycle(hier, 0, static)
        finally:
            if collecting:
                gc.enable()
        self.graph, self.b, self.x = graph, static, x

    def replay(self, b: torch.Tensor) -> torch.Tensor:
        """The cycle on ``b``: a new tensor."""
        with torch.cuda.device(b.device):
            self.b.copy_(b)
            self.graph.replay()
            return self.x.clone()


def _coarse_correct(level: Level, hier: Hierarchy, idx: int,
                    r: torch.Tensor) -> torch.Tensor:
    rc = tf.restrict_fast(level.tplan, r)
    if (hier.cycle == "kcycle" and idx + 1 < len(hier.levels)
            and idx + 1 <= hier.kcycle_depth):
        xc = _kcycle_accel(hier, idx + 1, rc)
    else:
        xc = _cycle(hier, idx + 1, rc)
    return tf.prolong_fast(level.tplan, xc, r.shape[0])


def _cycle(hier: Hierarchy, idx: int, b: torch.Tensor) -> torch.Tensor:
    if idx == len(hier.levels):
        return hier.coarse.solve(b)
    with timing.span("level", idx):
        return _level_cycle(hier, idx, b)


def _smooth(level: Level, idx: int, b: torch.Tensor,
            x: torch.Tensor | None = None) -> torch.Tensor:
    """One smoothing application on level ``idx`` (from zero when ``x``
    is None), inside a ``smooth`` span."""
    with timing.span("smooth", idx):
        if x is None:
            return level.smoother.solve(level.a, b)
        return level.smoother.apply(level.a, b, x)


def _level_cycle(hier: Hierarchy, idx: int,
                 b: torch.Tensor) -> torch.Tensor:
    level = hier.levels[idx]
    a = level.a
    if hier.combination == "additive":
        # the coarse correction and the smoother both act on b, summed
        return (_coarse_correct(level, hier, idx, b)
                + _smooth(level, idx, b))
    if hier.pre_smooth == 0:
        # coarse-grid correction of b itself, then post-smoothing: the
        # multiplicative two-level combination c + S(b − A c)
        x = _coarse_correct(level, hier, idx, b)
    else:
        x = _smooth(level, idx, b)
        for _ in range(hier.pre_smooth - 1):
            x = _smooth(level, idx, b, x)
        r = b - ops.spmv(a, x)
        x = x + _coarse_correct(level, hier, idx, r)
    for _ in range(hier.post_smooth):
        x = _smooth(level, idx, b, x)
    return x


def _kcycle_accel(hier: Hierarchy, idx: int,
                  b: torch.Tensor) -> torch.Tensor:
    """Notay K-cycle: ``kcycle_steps`` iterations of flexible CG
    preconditioned with the cycle at this level."""
    a = hier.levels[idx].a if idx < len(hier.levels) else hier.coarse.a
    # a level split over ranks holds local rows: its dots are all-reduced
    dot = a.mesh.dot if hasattr(a, "mesh") else torch.dot
    x = torch.zeros_like(b)
    r = b
    dirs: list[tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = []
    for _ in range(hier.kcycle_steps):
        z = _cycle(hier, idx, r)
        p = z
        for (pj, apj, denom) in dirs:
            p = p - (dot(apj, p) / denom) * pj
        ap = ops.spmv(a, p)
        denom = dot(p, ap)
        alpha = torch.where(denom != 0.0, dot(p, r) / denom, 0.0)
        x = x + alpha * p
        r = r - alpha * ap
        dirs.append((p, ap, denom))
    return x


def build_hierarchy(a: ELL, level_labels: list[torch.Tensor],
                    coarse_ops: list[ELL], smoother_kind: str = "chebyshev",
                    cycle: str = "vcycle", pre_smooth: int = 0,
                    post_smooth: int = 1, kcycle_depth: int = 3,
                    combination: str = "multiplicative",
                    lmax: list[float] | None = None,
                    smoother_state: list[dict] | None = None,
                    p_ops: list[ELL] | None = None,
                    pt_ops: list[ELL] | None = None,
                    **smoother_kw) -> Hierarchy:
    """Assemble a Hierarchy from setup outputs.

    ``level_labels[l]`` takes the level-l row space to level-(l+1)
    aggregates; ``coarse_ops[l]`` is the level-(l+1) operator.  Each
    level operator is repacked into the DIA+ELL hybrid; the smoother
    (``make_smoother``'s keywords in ``smoother_kw``) is made on the
    hybrid, with the level's ELL for ``ilu0``'s factors.  ``lmax``:
    per-level λmax values (safety factor included) to use instead of the
    power-iteration estimate; ``smoother_state``: per-level tensors to use
    instead of the computed ones (``make_smoother``'s ``state``).
    ``p_ops``/``pt_ops``: per-level explicit prolongations and their
    transposes (smoothed aggregation); each level's transfers are then
    those weighted operators, never the labels'."""
    if combination not in COMBINATIONS:
        raise ValueError(f"unknown combination {combination!r}; one of "
                         f"{COMBINATIONS}")
    mats = [a] + list(coarse_ops)
    levels = []
    for l, labels in enumerate(level_labels):
        fine, coarse = mats[l], mats[l + 1]
        lab = labels.to(device=fine.device, dtype=torch.int32)
        if lab.shape[0] < fine.npad:
            lab = torch.cat([lab, lab.new_full((fine.npad - lab.shape[0],),
                                               -1)])
        lab = lab[: fine.npad].contiguous()
        op = hyb.hybrid_from_ell(fine)
        if p_ops is not None:
            tplan = tf.build_transfer_plan_from_p(p_ops[l], pt_ops[l],
                                                  coarse.npad)
        else:
            tplan = tf.build_transfer_plan(lab, coarse.npad,
                                           fine.vals.dtype)
        sm = make_smoother(op, kind=smoother_kind, ell=fine,
                           lmax=None if lmax is None else lmax[l],
                           state=None if smoother_state is None
                           else smoother_state[l], level=l, **smoother_kw)
        levels.append(Level(a=op, labels=lab, smoother=sm, tplan=tplan,
                            nc_pad=coarse.npad))
    return Hierarchy(levels=tuple(levels),
                     coarse=make_coarse_solve(mats[-1]), cycle=cycle,
                     pre_smooth=pre_smooth, post_smooth=post_smooth,
                     kcycle_depth=kcycle_depth, combination=combination)
