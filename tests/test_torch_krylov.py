"""The port's Krylov methods, two-level preconditioner and one-call solve
against the JAX package's plan-free CPU path, in float32 and float64:

* ``two_level_from_p`` on poisson2d(32) with P of 2×2-node aggregates
  (``galerkin_ell``'s Ac, dense LU), gs2 multiplicative and additive and
  ilu0, each with BiCGStab: the same iteration counts, the solution to
  rtol 1e-6 / 1e-12 of its norm;
* FCG and GMRES(30) on the gs2 two-level preconditioner: the same counts;
* method ``"none"`` (BiCGStab without a preconditioner) on the shifted
  operator A + 2I: the same count; on A itself its first five iterates
  (unpreconditioned BiCGStab on poisson2d(32) amplifies last-bit
  differences about 10¹²-fold in forty iterations, so its count there
  is the rounding's, the JAX package's own included);
* the ilu0 smoother with the JAX factors carried over through
  ``interop.hierarchy_from_numpy`` (apply parity apart from factor
  parity);
* ``solve()`` from a ``SolveConfig`` (gs2 K-cycle on three levels, the
  coarsest at most 256 rows) to 1e-4, with and without refinement, in float32: the same
  counts.  The refinement's inner solves stop at 1e-4: at 1e-6 the second
  one starts from a residual that is mostly the rounding of the f32
  solution, which the two packages round differently (9 against 10 inner
  iterations)."""
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp
from multigridsolver_tpu.setup.prolongation import p_csr_from_labels as \
    j_p_from_labels
from multigridsolver_tpu.solve import api as japi
from multigridsolver_tpu.sparse.formats import CSR as JCSR
from multigridsolver_tpu.utils import config as jcfg
from multigridsolver_tpu_torch import interop
from multigridsolver_tpu_torch.cli import generators as tgen
from multigridsolver_tpu_torch.setup.prolongation import p_csr_from_labels
from multigridsolver_tpu_torch.solve import api as tapi
from multigridsolver_tpu_torch.sparse.formats import CSR as TCSR
from multigridsolver_tpu_torch.utils import config as tcfg

N = 32
DTYPES = {"f32": (jnp.float32, torch.float32, 1e-6),
          "f64": (jnp.float64, torch.float64, 1e-12)}
# name: (two_level_from_p keywords, Krylov method)
RUNS = {"gs2": (dict(smoother_kind="gs2"), "bicgstab"),
        "gs2_additive": (dict(smoother_kind="gs2", combination="additive"),
                         "bicgstab"),
        "ilu0": (dict(smoother_kind="ilu0"), "bicgstab"),
        "gs2_fcg": (dict(smoother_kind="gs2"), "fcg"),
        "gs2_gmres": (dict(smoother_kind="gs2"), "gmres")}
SOLVE = dict(tol=1e-6, maxiter=300)


@pytest.fixture(scope="module", autouse=True)
def no_warmset():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MGS_NO_WARMSET", "1")
        yield


def problem(shift: float = 0.0):
    """poisson2d(32) (+ shift · I) as scipy CSR, the right-hand side, and
    the 2×2-block aggregates' P as labels."""
    m = (tgen.poisson2d(N).to_scipy() + shift * sp.identity(N * N)).tocsr()
    m.sort_indices()
    i, j = np.divmod(np.arange(N * N), N)
    labels = ((i // 2) * (N // 2) + j // 2).astype(np.int32)
    return m, np.random.RandomState(0).rand(N * N), labels


def result(res, x=None):
    return dict(iterations=int(res.iterations), relres=float(res.relres),
                status=int(res.status),
                x=np.asarray(res.x if x is None else x, dtype=np.float64))


@pytest.fixture(scope="module")
def ref():
    """The JAX package's runs, per dtype."""
    m, b, labels = problem()
    out = {}
    for dt, (jdt, _, _) in DTYPES.items():
        a = JCSR.from_scipy(m)
        p = j_p_from_labels(labels, int(labels.max()) + 1)
        runs = {}
        hiers = {}
        for name, (kw, method) in RUNS.items():
            key = tuple(sorted(kw.items()))
            if key not in hiers:
                hiers[key] = japi.two_level_from_p(a, p, dtype=jdt, **kw)
            runs[name] = result(japi.solve_hierarchy(
                hiers[key], b, method=method, **SOLVE))
            if name == "ilu0":
                sm = hiers[key].levels[0].smoother
                runs[name]["state"] = dict(
                    d=np.asarray(sm.d), lvals=np.asarray(sm.lmat.vals),
                    uvals=np.asarray(sm.umat.vals), udiag=np.asarray(sm.udiag))
                lvl = hiers[key].levels[0]
                runs[name]["labels"] = np.asarray(lvl.labels)
                runs[name]["ac"] = hiers[key].coarse.a
        shifted = JCSR.from_scipy(problem(2.0)[0])
        h = japi.two_level_from_p(shifted, p, dtype=jdt)
        runs["none_shifted"] = result(japi.solve_hierarchy(
            h, b, method="none", **SOLVE))
        runs["none_5"] = result(japi.solve_hierarchy(
            hiers[(("smoother_kind", "gs2"),)], b, method="none",
            tol=1e-30, maxiter=5))
        out[dt] = runs
    return out


def port_hierarchy(dt, shift=0.0, **kw):
    m, _, labels = problem(shift)
    return tapi.two_level_from_p(
        TCSR.from_scipy(m), p_csr_from_labels(labels, int(labels.max()) + 1),
        dtype=DTYPES[dt][1], device="cpu", **kw)


def check_same(got, want, rtol):
    assert got.status == 0 == want["status"]
    assert got.iterations == want["iterations"]
    x = got.x.double().numpy()
    np.testing.assert_allclose(x, want["x"], rtol=rtol,
                               atol=rtol * np.abs(want["x"]).max())


@pytest.mark.parametrize("name", list(RUNS))
@pytest.mark.parametrize("dt", list(DTYPES))
def test_two_level_and_krylov_match_jax(ref, dt, name):
    kw, method = RUNS[name]
    h = port_hierarchy(dt, **kw)
    assert (h.combination, h.cycle, h.pre_smooth, h.post_smooth) == (
        kw.get("combination", "multiplicative"), "vcycle", 0, 1)
    _, b, _ = problem()
    check_same(tapi.solve_hierarchy(h, b, method=method, **SOLVE),
               ref[dt][name], DTYPES[dt][2])


@pytest.mark.parametrize("dt", list(DTYPES))
def test_two_level_coarse_operator_bitwise(ref, dt):
    """``two_level_from_p``'s Ac (``galerkin_ell``) equals the JAX
    package's bit for bit."""
    want = ref[dt]["ilu0"]["ac"]
    got = port_hierarchy(dt, smoother_kind="ilu0").coarse.a
    assert (got.nrows, got.npad, got.k) == (want.nrows, want.npad, want.k)
    for f in ("cols", "vals", "rownnz"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)))


@pytest.mark.parametrize("dt", list(DTYPES))
def test_method_none_matches_jax(ref, dt):
    _, b, _ = problem()
    check_same(tapi.solve_hierarchy(port_hierarchy(dt, shift=2.0), b,
                                    method="none", **SOLVE),
               ref[dt]["none_shifted"], DTYPES[dt][2])
    # on A itself: the first five iterates (no preconditioner is applied)
    got = tapi.solve_hierarchy(port_hierarchy(dt, smoother_kind="gs2"), b,
                               method="none", tol=1e-30, maxiter=5)
    want = ref[dt]["none_5"]
    assert got.iterations == want["iterations"] == 5
    rtol = DTYPES[dt][2]
    np.testing.assert_allclose(got.x.double().numpy(), want["x"], rtol=rtol,
                               atol=rtol * np.abs(want["x"]).max())


@pytest.mark.parametrize("dt", list(DTYPES))
def test_ilu0_with_carried_factors(ref, dt):
    """The JAX factors carried over: the same count, and the hierarchy
    holds them unchanged."""
    r = ref[dt]["ilu0"]
    want = r["ac"]
    m, b, _ = problem()
    a = TCSR.from_scipy(m).to_ell(dtype=DTYPES[dt][1], device="cpu")

    def ell(e):
        return dict(cols=np.asarray(e.cols), vals=np.asarray(e.vals),
                    rownnz=np.asarray(e.rownnz), nrows=e.nrows,
                    ncols=e.ncols)
    mats = [dict(cols=a.cols.numpy(), vals=a.vals.numpy(),
                 rownnz=a.rownnz.numpy(), nrows=a.nrows, ncols=a.ncols),
            ell(want)]
    h = interop.hierarchy_from_numpy(
        mats, [r["labels"]], smoother_state=[r["state"]], device="cpu",
        smoother_kind="ilu0", cycle="vcycle", pre_smooth=0, post_smooth=1)
    sm = h.levels[0].smoother
    np.testing.assert_array_equal(sm.lmat.vals.numpy(), r["state"]["lvals"])
    np.testing.assert_array_equal(sm.udiag.numpy(), r["state"]["udiag"])
    check_same(tapi.solve_hierarchy(h, b, method="bicgstab", **SOLVE), r,
               DTYPES[dt][2])
    with pytest.raises(ValueError, match="smoother state"):
        interop.hierarchy_from_numpy(
            mats, [r["labels"]], smoother_state=[dict(d=r["state"]["d"][:8])],
            device="cpu", smoother_kind="ilu0")


@pytest.mark.parametrize("refine", [0, 3])
def test_solve_config_matches_jax(refine):
    """``solve()``: setup, gs2 K-cycle and BiCGStab to 1e-4 from one
    config, in float32, alone and inside f64 refinement to 1e-9 (one
    tolerance, so that the JAX package compiles one solve program)."""
    m, b, _ = problem()
    kw = dict(method="bicgstab", tol=1e-4, max_iter=300, cycle="kcycle",
              dtype="float32", refine_outer=refine, refine_tol=1e-9)
    agg = dict(tcfg.BENCH_AGGREGATION)
    jc = jcfg.SolveConfig(smoother=jcfg.SmootherConfig(kind="gs2"),
                          hierarchy=jcfg.HierarchyConfig(
                              max_coarse_size=256,
                              aggregation=jcfg.AggregationConfig(**agg)),
                          **kw)
    tc = tcfg.SolveConfig(smoother=tcfg.SmootherConfig(kind="gs2"),
                          hierarchy=tcfg.HierarchyConfig(
                              max_coarse_size=256,
                              aggregation=tcfg.AggregationConfig(**agg)),
                          **kw)
    jx, jinfo = japi.solve(JCSR.from_scipy(m), b, jc)
    tx, tinfo = tapi.solve(TCSR.from_scipy(m), b, tc, device="cpu")
    assert ([lv.a.nrows for lv in tinfo["hierarchy"].levels]
            == [lv.a.nrows for lv in jinfo["hierarchy"].levels])
    assert tinfo["hierarchy"].levels[0].smoother.kind == "gs2"
    if refine:
        assert (tinfo["inner_iterations"], tinfo["outer_sweeps"]) == (
            jinfo["inner_iterations"], jinfo["outer_sweeps"])
        assert tinfo["relres"] < 1e-9 and tx.dtype == np.float64
    else:
        assert (tinfo["iterations"], tinfo["status"]) == (
            jinfo["iterations"], 0)
        np.testing.assert_allclose(tx, np.asarray(jx), rtol=1e-6,
                                   atol=1e-6 * np.abs(np.asarray(jx)).max())
        assert tinfo["relres"] < 1e-4


def test_unknown_method_and_combination():
    h = port_hierarchy("f64", smoother_kind="jacobi")
    with pytest.raises(ValueError, match="unknown method"):
        tapi.solve_hierarchy(h, np.ones(N * N), method="minres")
    with pytest.raises(ValueError, match="unknown combination"):
        port_hierarchy("f64", combination="hybrid")
