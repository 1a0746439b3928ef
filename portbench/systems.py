"""The system under test, driven one request at a time.

A traffic mix names one of three request kinds; each is a class here that
sets the program up from a configuration, serves requests from the
stream, keeps what each request produced, and judges it afterwards with
``reference.py``:

* ``solve``: one ``solve_hierarchy`` (the hierarchy as right
  preconditioner) for a new right-hand side, on a hierarchy built in
  set-up; on a row mesh over ranks (``ranks`` > 1 in the traffic) the
  hierarchy is sharded and rank 0 reads each x whole with ``host_read``.
  Judged by x's worst entry against the exact solution.
* ``build``: one preconditioner build, ``build_amg_setup`` then
  ``build_hierarchy``, from a copy of the matrix already on the card.
  Judged, for the first build and a sample drawn from the seed
  (``sample`` in the traffic), by the coarse operators against Pᵀ A P
  worked out again from the labels, by whether the labels form an
  aggregation, and by the hierarchy it built: once the window has
  closed, one ``solve_hierarchy`` on each kept hierarchy for a seeded
  right-hand side, its x against the exact solution of the scaled
  matrix, and whether it converged.
* ``solution``: from the host CSR to x: ``to_ell`` → ``build_amg_setup``
  → ``build_hierarchy`` → ``solve_refined``.  Judged by x's true
  residual in float64 and, as ``build``, by its coarse operators (both
  value fields) and labels.

Only this module and the rank launcher import the program.
"""
from __future__ import annotations

import dataclasses
import gc

import torch

from . import reference
from .generators import generate
from .trace import Record, sync
from .traffic import WARMUP, Stream


def _dtype(name: str) -> torch.dtype:
    return {"float32": torch.float32, "float64": torch.float64}[name]


def hierarchy_config(cfg: dict):
    from multigridsolver_tpu_torch.utils.config import (AggregationConfig,
                                                        HierarchyConfig)
    s = cfg["setup"]
    return HierarchyConfig(max_levels=int(s["max_levels"]),
                           max_coarse_size=int(s["max_coarse_size"]),
                           aggregation=AggregationConfig(**s["aggregation"]))


def ell_entries(e):
    """(keys row·ncols + col, float64 values) of the logical rows of a
    program ELL's stored slots, and the same of its transposed-value
    field keyed (col, row) where it has one; the oracle's view of the
    program's output."""
    rows = torch.arange(e.npad, device=e.cols.device)
    keep = (torch.arange(e.k, device=e.cols.device)[:, None]
            < e.rownnz[None, :].long()) & (rows < e.nrows)[None, :]
    r = rows[None, :].expand(e.k, -1)[keep]
    c = e.cols.long()[keep]
    fwd = reference._merge(r * e.ncols + c, e.vals.double()[keep])
    if e.vals_t is None:
        return fwd, None
    return fwd, reference._merge(c * e.ncols + r, e.vals_t.double()[keep])


def setup_errors(a_keys, a_vals, ncols: int, s: float, labels, coarse,
                 max_size: int, dtype=torch.float64) -> dict:
    """The worst relative error of the program's coarse operators
    (``coarse``, program ELLs; both value fields where the transposed one
    is kept) against Pᵀ A P worked out again from ``labels`` and the
    benchmark's matrix scaled by ``s`` (``dtype``: the reference's
    precision), and the labels' faults as an aggregation."""
    keys, vals = a_keys, (a_vals * s).to(dtype)
    err, faults = 0.0, 0
    for lab, e in zip(labels, coarse):
        nc = e.nrows
        faults += reference.aggregation_faults(lab, nc, max_size)
        keys, vals = reference.galerkin(keys, vals, ncols, lab, nc)
        ncols = nc
        fwd, bwd = ell_entries(e)
        err = max(err, reference.operator_error(*fwd, keys, vals))
        if bwd is not None:
            err = max(err, reference.operator_error(*bwd, keys, vals))
    return dict(galerkin_error=err, aggregation_faults=faults)


class System:
    """What every request kind shares: the configuration, the matrix
    (the benchmark's own generator), the stream and the record."""

    def __init__(self, config: dict, traffic: dict, device, rec: Record,
                 seed: int, mesh=None):
        self.config, self.traffic = config, traffic
        self.device = torch.device(device)
        self.rec, self.mesh = rec, mesh
        self.dtype = _dtype(config["dtype"])
        self.a = generate(config["generator"])
        self.n = self.a.shape[0]
        self.stream = Stream(traffic, seed, self.n, self.device)
        self.kept: list = []

    def reseed(self, seed: int) -> None:
        """Draw the next requests from ``seed`` (calibration only)."""
        self.stream = Stream(self.traffic, seed, self.n, self.device)
        self.kept = []

    @property
    def is_reporter(self) -> bool:
        """Whether this process prints the result (rank 0 of a mesh)."""
        return self.mesh is None or self.mesh.rank == 0

    def build(self, ell):
        """``build_amg_setup`` → ``build_hierarchy`` on ``ell``, each
        inside its span."""
        from multigridsolver_tpu_torch.setup.aggregation import \
            build_amg_setup
        from multigridsolver_tpu_torch.solve.hierarchy import \
            build_hierarchy
        with self.rec.span("build_amg_setup"):
            setup = build_amg_setup(ell, hierarchy_config(self.config))
        with self.rec.span("build_hierarchy"):
            hier = build_hierarchy(setup.matrices[0], setup.level_labels,
                                   setup.matrices[1:],
                                   **self.config["hierarchy"])
        return setup, hier

    def keep_setup(self, setup) -> tuple:
        """A setup's labels (logical rows, int64) and coarse operators."""
        labels = [lab[: m.nrows].long()
                  for lab, m in zip(setup.level_labels, setup.matrices)]
        return labels, list(setup.matrices[1:])

    def release(self) -> None:
        """Free the program's state (kept outputs stay)."""
        for name in ("hier", "copies", "base", "csr"):
            self.__dict__.pop(name, None)
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def a_entries(self):
        return reference.coo_of_scipy(self.a, self.device)

    def galerkin_control(self, s: float, labels) -> float:
        """The coarse operators' error when the reference's Pᵀ A P in
        bfloat16 takes the program's place (on the program's labels)."""
        keys, vals = self.a_entries()
        low = reference.galerkin_chain(keys, vals, self.n, s, labels,
                                       torch.bfloat16)
        ref = reference.galerkin_chain(keys, vals, self.n, s, labels,
                                       torch.float64)
        return max(reference.operator_error(lk, lv, rk, rv)
                   for (lk, lv, _), (rk, rv, _) in zip(low, ref))

    def max_aggregate(self) -> int:
        return 2 ** int(self.config["setup"]["aggregation"]["npass"])

    def exact_grid(self) -> int:
        """The grid of the one matrix whose exact solution the reference
        computes (the Poisson sine transform)."""
        gen = self.config["generator"]
        if gen["name"] != "poisson2d":
            raise NotImplementedError(
                f"solutions are judged against the exact Poisson "
                f"solution; {gen['name']} has none here")
        return int(gen["grid"])

    def solve(self, hier, b):
        """``solve_hierarchy`` on ``hier`` with the configuration's solve
        settings."""
        from multigridsolver_tpu_torch.solve.api import solve_hierarchy
        sv = self.config["solve"]
        return solve_hierarchy(hier, b, method=sv["method"],
                               tol=float(sv["tol"]),
                               maxiter=int(sv["maxiter"]))


class SolveSystem(System):
    """``solve``: one ``solve_hierarchy`` per request on a hierarchy built
    in set-up; over ranks on a sharded hierarchy."""

    def setup(self) -> None:
        from multigridsolver_tpu_torch.sparse.formats import CSR
        csr = CSR.from_scipy(self.a)
        ell = csr.to_ell(dtype=self.dtype, device=self.device,
                         **self.config.get("pack", {}))
        if self.mesh is None:
            self.setup_result, self.hier = self.build(ell)
        else:
            from multigridsolver_tpu_torch.parallel import (
                build_amg_setup_sharded, gather_setup, shard_hierarchy)
            from multigridsolver_tpu_torch.solve.hierarchy import \
                build_hierarchy
            cfg = hierarchy_config(self.config)
            setup = build_amg_setup_sharded(ell, cfg, self.mesh)
            whole = gather_setup(setup, ell, self.mesh)
            hier = build_hierarchy(whole.matrices[0], whole.level_labels,
                                   whole.matrices[1:],
                                   **self.config["hierarchy"])
            self.hier = shard_hierarchy(
                hier, self.mesh,
                shard_levels=int(self.traffic.get("shard_levels", 1)))
            self.setup_result = whole
        self.levels = [m.nrows for m in self.setup_result.matrices]
        del self.setup_result
        self.solve_one(WARMUP, keep=False)
        if self.rec.traced:
            self.hier.precondition = self.rec.wrap("precondition",
                                                   self.hier.precondition)
            self.hier.matvec = self.rec.wrap("matvec", self.hier.matvec)

    def solve_one(self, i: int, keep: bool = True) -> bool:
        b = self.stream.rhs(i)
        comm = self.mesh.comm if self.mesh is not None else None
        if comm is not None:
            comm.reset_counts()
        with self.rec.span("solve_hierarchy"):
            res = self.solve(self.hier, b)
        sync(self.device)
        if keep:
            self.rec.count("iterations", res.iterations)
            if comm is not None:
                self.rec.count("transport_bytes", sum(comm.sent.values()))
            self.kept.append((i, res.x))
        return res.status == 0

    request = solve_one

    def check(self) -> dict:
        """x's worst entry against the exact solution, over every kept
        request; over ranks every rank reads x whole, rank 0 judges."""
        from multigridsolver_tpu_torch.parallel import host_read
        grid = self.exact_grid()
        worst = 0.0
        for i, x in self.kept:
            if self.mesh is not None:
                x = torch.from_numpy(host_read(x, self.mesh)[: self.n])
            if not self.is_reporter:
                continue
            b = self.stream.rhs(i).double()
            x_ref = reference.poisson_solve(b, grid)
            worst = max(worst, reference.forward_error(x, x_ref))
        return dict(forward_error=worst)

    def control(self, i: int) -> dict:
        """The reference in bfloat16 in the program's place."""
        grid = self.exact_grid()
        b = self.stream.rhs(i).double()
        x = reference.poisson_solve(b, grid, dtype=torch.bfloat16)
        return dict(forward_error=reference.forward_error(
            x, reference.poisson_solve(b, grid)))


class BuildSystem(System):
    """``build``: one ``build_amg_setup`` + ``build_hierarchy`` per
    request, from ``copies`` scaled copies of the matrix made on the card
    in set-up, taken in turn."""

    def setup(self) -> None:
        from multigridsolver_tpu_torch.sparse.formats import CSR
        ell = CSR.from_scipy(self.a).to_ell(
            dtype=self.dtype, device=self.device,
            **self.config.get("pack", {}))
        self.base = ell
        self.make_copies()
        self.build(ell)
        sync(self.device)

    def make_copies(self) -> None:
        self.scales = self.stream.scales()
        self.copies = [dataclasses.replace(self.base,
                                           vals=self.base.vals * s)
                       for s in self.scales]

    def reseed(self, seed: int) -> None:
        super().reseed(seed)
        self.make_copies()

    def request(self, i: int) -> bool:
        c = i % len(self.copies)
        setup, hier = self.build(self.copies[c])
        sync(self.device)
        if i == 0 or self.stream.sampled(i):
            self.kept.append((i, c, *self.keep_setup(setup), hier))
        self.levels = [m.nrows for m in setup.matrices]
        return True

    def check(self) -> dict:
        """Over every kept build: its coarse operators and labels, and
        one solve on its hierarchy for request i's right-hand side, x
        against the exact solution of the matrix scaled as the build's
        copy, and whether the solve converged."""
        keys, vals = self.a_entries()
        grid = self.exact_grid()
        worst = dict(galerkin_error=0.0, aggregation_faults=0,
                     forward_error=0.0)
        failures = 0
        for i, c, labels, coarse, hier in self.kept:
            got = setup_errors(keys, vals, self.n, self.scales[c], labels,
                               coarse, self.max_aggregate())
            b = self.stream.rhs(i)
            res = self.solve(hier, b)
            failures += int(res.status != 0)
            x_ref = reference.poisson_solve(b.double(), grid) / self.scales[c]
            got["forward_error"] = reference.forward_error(res.x, x_ref)
            worst = {k: max(worst[k], got[k]) for k in worst}
        return dict(worst, solve_failures=failures)

    def control(self, i: int) -> dict:
        """The reference in bfloat16 in the program's place: Pᵀ A P on a
        kept build's labels, and the exact solve of that build's scaled
        matrix for request i's right-hand side."""
        _, c, labels, _, _ = self.kept[i % len(self.kept)]
        b = self.stream.rhs(i).double()
        grid = self.exact_grid()
        s = self.scales[c]
        x = reference.poisson_solve(b, grid, dtype=torch.bfloat16) / s
        return dict(galerkin_error=self.galerkin_control(s, labels),
                    forward_error=reference.forward_error(
                        x, reference.poisson_solve(b, grid) / s))


class SolutionSystem(System):
    """``solution``: from the host CSR to x through ``solve_refined``."""

    def setup(self) -> None:
        from multigridsolver_tpu_torch.sparse.formats import CSR
        self.csr = CSR.from_scipy(self.a)
        self.solution_one(WARMUP, keep=False)

    def solution_one(self, i: int, keep: bool = True) -> bool:
        from multigridsolver_tpu_torch.solve.api import solve_refined
        rf = self.config["refine"]
        b = self.stream.rhs(i)
        with self.rec.span("to_ell"):
            ell = self.csr.to_ell(dtype=self.dtype, device=self.device,
                                  **self.config.get("pack", {}))
        setup, hier = self.build(ell)
        if self.rec.traced:
            hier.precondition = self.rec.wrap("precondition",
                                              hier.precondition)
        with self.rec.span("solve_refined"):
            x, relres, inner, outer = solve_refined(
                hier, self.csr, b, tol=float(rf["tol"]),
                inner_tol=float(rf["inner_tol"]),
                method=self.config["solve"]["method"],
                max_outer=int(rf["max_outer"]), maxiter=int(rf["maxiter"]))
        sync(self.device)
        if keep:
            self.rec.count("inner_iterations", inner)
            self.rec.count("outer_sweeps", outer)
            self.kept.append((i, x, *self.keep_setup(setup)))
        self.hier = hier
        self.levels = [m.nrows for m in setup.matrices]
        return bool(relres < float(rf["tol"]))

    request = solution_one

    def check(self) -> dict:
        keys, vals = self.a_entries()
        worst = dict(true_residual=0.0, galerkin_error=0.0,
                     aggregation_faults=0)
        for i, x, labels, coarse in self.kept:
            got = setup_errors(keys, vals, self.n, 1.0, labels, coarse,
                               self.max_aggregate())
            got["true_residual"] = reference.true_residual(
                self.a, self.stream.rhs(i), x)
            worst = {k: max(worst[k], got[k]) for k in worst}
        return worst

    def control(self, i: int) -> dict:
        """For x, the program's own float32 path in place of the float64
        refinement: one ``solve_hierarchy`` to the refined tolerance on
        the last request's hierarchy, x as the float32 solve returns it.
        For the coarse operators (float32), the reference's Pᵀ A P in
        bfloat16 on the last request's labels."""
        from multigridsolver_tpu_torch.solve.api import solve_hierarchy
        rf = self.config["refine"]
        b = self.stream.rhs(i)
        res = solve_hierarchy(self.hier, b,
                              method=self.config["solve"]["method"],
                              tol=float(rf["tol"]),
                              maxiter=int(rf["maxiter"]))
        return dict(true_residual=reference.true_residual(
            self.a, b, res.x.double().cpu().numpy()),
            galerkin_error=self.galerkin_control(1.0, self.kept[-1][2]))


KINDS = {"solve": SolveSystem, "build": BuildSystem,
         "solution": SolutionSystem}


def make(config: dict, traffic: dict, device, rec: Record, seed: int,
         mesh=None) -> System:
    return KINDS[traffic["request"]](config, traffic, device, rec, seed,
                                     mesh=mesh)
