"""The port's solve path against the JAX package (CPU): the K-cycle
preconditioner and BiCGStab on the JAX setup carried over through
``interop.py``, the whole slice end to end, and the Krylov and smoother
building blocks."""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import scipy.sparse as sp
import torch

from multigridsolver_tpu.cli.generators import poisson2d
from multigridsolver_tpu.setup.aggregation import build_amg_setup
from multigridsolver_tpu.solve import smoothers as jsm
from multigridsolver_tpu.solve.api import solve_hierarchy as j_solve
from multigridsolver_tpu.solve.hierarchy import build_hierarchy as j_build
from multigridsolver_tpu.utils.config import (AggregationConfig,
                                              HierarchyConfig)
from multigridsolver_tpu_torch import interop
from multigridsolver_tpu_torch.cli import generators as tgen
from multigridsolver_tpu_torch.parallel import RowMesh, shard_hierarchy
from multigridsolver_tpu_torch.setup.aggregation import build_amg_setup \
    as t_setup
from multigridsolver_tpu_torch.setup.galerkin import (galerkin_ell,
                                                      galerkin_pair_ell)
from multigridsolver_tpu_torch.setup.prolongation import labels_from_p_csr
from multigridsolver_tpu_torch.solve import hierarchy as thier
from multigridsolver_tpu_torch.solve import krylov
from multigridsolver_tpu_torch.solve import smoothers as tsm
from multigridsolver_tpu_torch.solve.api import pad_vector, solve_hierarchy
from multigridsolver_tpu_torch.solve.hierarchy import (build_hierarchy,
                                                       make_coarse_solve)
from multigridsolver_tpu_torch.sparse import ops as tops
from multigridsolver_tpu_torch.utils import config as tcfg
from multigridsolver_tpu_torch.utils import timing

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_GRID = 128
AGG = tcfg.BENCH_AGGREGATION
HIER = tcfg.BENCH_HIERARCHY
DTYPES = {"f32": (jnp.float32, torch.float32),
          "f64": (jnp.float64, torch.float64)}


def ell_dict(e):
    return dict(cols=np.asarray(e.cols), vals=np.asarray(e.vals),
                rownnz=np.asarray(e.rownnz), nrows=e.nrows, ncols=e.ncols)


@pytest.fixture(scope="module")
def ref():
    """One JAX reference run per dtype on poisson2d(128): setup, the
    bench's hierarchy, a BiCGStab solve and one preconditioner
    application."""
    out = {}
    b = np.random.RandomState(0).rand(N_GRID * N_GRID)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MGS_NO_WARMSET", "1")
        cfg = HierarchyConfig(max_coarse_size=512,
                              aggregation=AggregationConfig(**AGG))
        for dt, (jdt, _) in DTYPES.items():
            s = build_amg_setup(poisson2d(N_GRID).to_ell(dtype=jdt), cfg)
            h = j_build(s.matrices[0], s.level_labels, s.matrices[1:], **HIER)
            res = j_solve(h, b, method="bicgstab", tol=1e-6, maxiter=200)
            v = np.random.RandomState(1).rand(h.levels[0].a.npad).astype(
                np.dtype(jdt))
            z = np.asarray(jax.jit(lambda hh, vv: hh.precondition(vv))(
                h, jnp.asarray(v)))
            out[dt] = dict(
                matrices=[ell_dict(m) for m in s.matrices],
                labels=[np.asarray(l) for l in s.level_labels],
                lmax=[float(l.smoother.lmax) for l in h.levels],
                iterations=int(res.iterations), relres=float(res.relres),
                v=v, z=z, b=b)
    return out


def carried_hierarchy(r):
    return interop.hierarchy_from_numpy(r["matrices"], r["labels"],
                                        lmax_per_level=r["lmax"],
                                        device="cpu", **HIER)


@pytest.mark.parametrize("dt", list(DTYPES))
def test_precondition_matches_jax_with_lmax_carried(ref, dt):
    r = ref[dt]
    h = carried_hierarchy(r)
    z = h.precondition(torch.from_numpy(r["v"])).numpy()
    rtol = 1e-5 if dt == "f32" else 1e-10
    np.testing.assert_allclose(z, r["z"], rtol=rtol,
                               atol=rtol * np.abs(r["z"]).max())


@pytest.mark.parametrize("dt", list(DTYPES))
def test_bicgstab_iterations_equal_with_lmax_carried(ref, dt):
    r = ref[dt]
    res = solve_hierarchy(carried_hierarchy(r), r["b"], method="bicgstab",
                          tol=1e-6, maxiter=200)
    assert res.status == 0 and res.relres < 1e-6
    assert res.iterations == r["iterations"]


@pytest.mark.parametrize("dt", list(DTYPES))
def test_whole_slice_matches_jax(ref, dt):
    """Port setup → port hierarchy (own λmax) → port solve."""
    r = ref[dt]
    cfg = tcfg.bench_config()
    s = t_setup(tgen.poisson2d(N_GRID).to_ell(dtype=DTYPES[dt][1],
                                                 device="cpu"), cfg)
    assert [m.nrows for m in s.matrices] == [m["nrows"]
                                             for m in r["matrices"]]
    h = build_hierarchy(s.matrices[0], s.level_labels, s.matrices[1:],
                        **HIER)
    res = solve_hierarchy(h, r["b"], method="bicgstab", tol=1e-6,
                          maxiter=200)
    assert res.status == 0 and res.relres < 1e-6
    assert abs(res.iterations - r["iterations"]) <= 1
    assert res.x.shape == (N_GRID * N_GRID,)


def spd_problem(n):
    a = tgen.poisson2d(n)
    return a, np.random.RandomState(42).rand(a.shape[0])


def test_solution_correct():
    """Two-level, labels = arange // 2, Chebyshev, CG to 1e-10 against a
    dense solve."""
    a, b = spd_problem(12)
    n = a.shape[0]
    labels = (np.arange(n) // 2).astype(np.int32)
    ell = a.to_ell(dtype=torch.float64, device="cpu")
    lab = torch.full((ell.npad,), -1, dtype=torch.int32)
    lab[:n] = torch.from_numpy(labels)
    paired = torch.full((ell.npad,), -1, dtype=torch.int32)
    paired[:n] = torch.from_numpy(np.arange(n) ^ 1).to(torch.int32)
    ac, _ = galerkin_pair_ell(ell, paired, lab, n // 2)
    hier = build_hierarchy(ell, [lab], [ac], smoother_kind="chebyshev",
                           cycle="vcycle", pre_smooth=0, post_smooth=1)
    res = solve_hierarchy(hier, b, method="cg", tol=1e-10)
    ref = np.linalg.solve(a.to_dense(), b)
    np.testing.assert_allclose(res.x.numpy(), ref, rtol=1e-6, atol=1e-8)


def test_labels_from_explicit_p_drive_a_two_level_solve():
    """The interchange form of P (explicit CSR) gives the same labels."""
    from multigridsolver_tpu_torch.setup.prolongation import p_csr_from_labels
    labels = (np.arange(144) // 2).astype(np.int32)
    back, nc = labels_from_p_csr(p_csr_from_labels(labels, 72))
    np.testing.assert_array_equal(back, labels)
    assert nc == 72


class TestKrylov:
    def test_cg_unpreconditioned(self):
        a, b = spd_problem(8)
        ell = a.to_ell(dtype=torch.float64, device="cpu")
        bp = pad_vector(b, ell.npad, torch.float64, "cpu")
        res = krylov.cg(lambda v: tops.spmv(ell, v), bp, tol=1e-10,
                        maxiter=2000)
        assert res.status == 0
        np.testing.assert_allclose(res.x.numpy()[: a.shape[0]],
                                   np.linalg.solve(a.to_dense(), b),
                                   rtol=1e-7, atol=1e-8)

    def test_bicgstab_nonsymmetric(self):
        rs = np.random.RandomState(3)
        n = 60
        m = sp.random(n, n, density=0.1, random_state=rs, format="csr")
        from multigridsolver_tpu_torch.sparse.formats import CSR
        a = CSR.from_scipy((m + 8.0 * sp.identity(n)).tocsr())
        b = rs.rand(n)
        ell = a.to_ell(dtype=torch.float64, device="cpu")
        res = krylov.bicgstab(lambda v: tops.spmv(ell, v),
                              pad_vector(b, ell.npad, torch.float64, "cpu"),
                              tol=1e-10, maxiter=500)
        assert res.status == 0
        np.testing.assert_allclose(a.to_scipy() @ res.x.numpy()[:n], b,
                                   rtol=0, atol=1e-8)

    def test_bicgstab_zero_rhs_and_maxiter(self):
        a, b = spd_problem(6)
        ell = a.to_ell(dtype=torch.float64, device="cpu")
        mv = lambda v: tops.spmv(ell, v)
        res = krylov.bicgstab(mv, torch.zeros(ell.npad, dtype=torch.float64),
                              tol=1e-8)
        assert (res.status, res.iterations) == (0, 0)
        bp = pad_vector(b, ell.npad, torch.float64, "cpu")
        res = krylov.bicgstab(mv, bp, tol=1e-14, maxiter=2)
        assert (res.status, res.iterations) == (1, 2)


class TestSmoothers:
    def test_chebyshev_matches_jax_with_same_lmax(self):
        a = poisson2d(16)
        je = a.to_ell(dtype=jnp.float64)
        te = tgen.poisson2d(16).to_ell(dtype=torch.float64, device="cpu")
        d = tsm.jacobi_diag(te, l1=True)
        np.testing.assert_array_equal(
            d.numpy(), np.asarray(jsm.jacobi_diag(je, l1=True)))
        rs = np.random.RandomState(7)
        b, x = rs.rand(te.npad), rs.rand(te.npad)
        y_t = tsm.chebyshev_apply(te, d, torch.tensor(1.7, dtype=torch.float64),
                                  torch.from_numpy(b), torch.from_numpy(x),
                                  3, 0.3).numpy()
        y_j = np.asarray(jsm.chebyshev_apply(
            je, jnp.asarray(d.numpy()), jnp.asarray(1.7), jnp.asarray(b),
            jnp.asarray(x), 3, 0.3))
        np.testing.assert_allclose(y_t, y_j, rtol=1e-12, atol=1e-12)

    def test_lmax_estimate_brackets_the_true_value(self):
        a = tgen.poisson2d(20)
        te = a.to_ell(dtype=torch.float64, device="cpu")
        d = tsm.jacobi_diag(te, l1=True).numpy()[: a.nrows]
        true = np.linalg.eigvals(a.to_dense() / d[:, None]).real.max()
        est = float(tsm.estimate_lmax(te, tsm.jacobi_diag(te, l1=True)))
        assert 0.9 * true <= est <= true * (1 + 1e-12)
        # a seeded generator: the same estimate every time
        assert est == float(tsm.estimate_lmax(te, tsm.jacobi_diag(te,
                                                                  l1=True)))

    def test_coarse_solve_matches_dense(self):
        a = tgen.poisson2d(9)
        cs = make_coarse_solve(a.to_ell(dtype=torch.float64, device="cpu"))
        assert cs.m == 88
        b = np.random.RandomState(8).rand(cs.a.npad)
        x = cs.solve(torch.from_numpy(b)).numpy()
        np.testing.assert_allclose(x[:81], np.linalg.solve(a.to_dense(),
                                                           b[:81]),
                                   rtol=1e-12)
        assert not x[88:].any()


def two_level_hierarchy():
    """poisson2d(16) in f64 over aggregates of 4 rows, the bench's
    cycle."""
    a = tgen.poisson2d(16).to_ell(dtype=torch.float64, device="cpu")
    lab = torch.full((a.npad,), -1, dtype=torch.int32)
    lab[:256] = torch.arange(256, dtype=torch.int32) // 4
    return build_hierarchy(a, [lab], [galerkin_ell(a, lab, 64)], **HIER)


def traced_calls(hier, b, calls=3):
    """``calls`` precondition calls under a tracer: the results and the
    tracer's counters."""
    tracer = timing.PhaseTimer()
    with timing.tracing(tracer):
        out = [hier.precondition(b) for _ in range(calls)]
    return out, tracer.counters


class TestCycleGraph:
    """``Hierarchy.precondition`` replays a CUDA graph only on the card:
    on the CPU and on a row mesh every call runs the cycle eagerly, and a
    copy of a hierarchy starts without a graph."""

    def test_cpu_hierarchy_never_captures(self):
        h = two_level_hierarchy()
        b = torch.from_numpy(np.random.RandomState(3).rand(
            h.levels[0].a.npad))
        out, counters = traced_calls(h, b)
        assert counters == {"kcycle.eager": 3}
        want = thier._cycle(h, 0, b)
        assert all(torch.equal(z, want) for z in out)
        assert h._graph is None

    def test_row_mesh_hierarchy_stays_eager(self):
        h = two_level_hierarchy()
        hs = shard_hierarchy(h, RowMesh(2, "cpu"))
        assert not thier._bound_to_mesh(h)
        assert thier._bound_to_mesh(hs)
        b = torch.from_numpy(np.random.RandomState(4).rand(
            hs.levels[0].a.npad))
        _, counters = traced_calls(hs, b)
        assert counters == {"kcycle.eager": 3}
        assert hs._graph is None

    def test_copies_carry_no_graph(self):
        h = two_level_hierarchy()
        # as after a first call on the card
        h._graph = thier.CycleGraph(torch.zeros(h.levels[0].a.npad,
                                                dtype=torch.float64))
        assert dataclasses.replace(h)._graph is None
        assert shard_hierarchy(h, RowMesh(2, "cpu"))._graph is None
        assert h._graph is not None
        assert "_graph" not in repr(h) and dataclasses.replace(h) == h


def test_interop_setup_roundtrip(ref):
    r = ref["f64"]
    s = interop.setup_from_numpy(r["matrices"], r["labels"],
                                 device="cpu")
    assert [m.nrows for m in s.matrices] == [m["nrows"]
                                             for m in r["matrices"]]
    for m, d in zip(s.matrices, r["matrices"]):
        np.testing.assert_array_equal(m.cols.numpy(), d["cols"])
        np.testing.assert_array_equal(m.vals.numpy(), d["vals"])
        assert m.vals.dtype == torch.float64


def test_port_imports_without_jax():
    code = ("import sys; sys.modules['jax'] = None; "
            "import multigridsolver_tpu_torch as m; "
            "from multigridsolver_tpu_torch import interop, setup, solve; "
            "from multigridsolver_tpu_torch.solve import api; "
            "assert 'jax' not in {k.split('.')[0] for k, v in "
            "sys.modules.items() if v is not None}; print('ok')")
    env = {**os.environ, "PYTHONPATH": REPO}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=REPO, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
