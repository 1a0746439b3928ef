"""The port's SpGEMM, transpose and smoothed aggregation against the JAX
package's plan-free path (CPU): ``spgemm_ell`` (random square and
rectangular, the stencil squared, width growth) with ``cols``/``rownnz``
equal and ``vals`` bitwise in f32 and f64; ``transpose_ell``,
``tentative_p``, the Jacobi operator I − ωD⁻¹A, ``smoothed_prolongation``
and ``galerkin_general`` bitwise; the weighted transfers to rtol 1e-6
(f32) / 1e-12 (f64); a ``smooth_p`` setup on poisson2d(32) and csky3d(10)
(levels, labels and P ops bitwise, the same K-cycle count); both
branches of ``refresh_setup`` bitwise; and ``shard_hierarchy``'s refusal
of a weighted plan."""
import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import scipy.sparse as sp
import torch

from multigridsolver_tpu.cli.generators import csky3d as j_csky3d
from multigridsolver_tpu.cli.generators import poisson2d as j_poisson2d
from multigridsolver_tpu.setup import aggregation as jagg
from multigridsolver_tpu.setup import smoothed as jsm
from multigridsolver_tpu.setup import transfers as jtf
from multigridsolver_tpu.solve.api import solve_hierarchy as j_solve
from multigridsolver_tpu.solve.hierarchy import build_hierarchy as j_build
from multigridsolver_tpu.sparse import ops as jops
from multigridsolver_tpu.sparse import spgemm as jsp
from multigridsolver_tpu.sparse.formats import CSR as JCSR
from multigridsolver_tpu.utils.config import (AggregationConfig,
                                              HierarchyConfig)
from multigridsolver_tpu_torch import interop
from multigridsolver_tpu_torch.parallel import RowMesh, shard_hierarchy
from multigridsolver_tpu_torch.setup import aggregation as tagg
from multigridsolver_tpu_torch.setup import smoothed as tsm
from multigridsolver_tpu_torch.setup import transfers as ttf
from multigridsolver_tpu_torch.solve.api import solve_hierarchy
from multigridsolver_tpu_torch.solve.hierarchy import build_hierarchy
from multigridsolver_tpu_torch.sparse import spgemm as tsp
from multigridsolver_tpu_torch.utils import config as tcfg

DTYPES = {"f32": jnp.float32, "f64": jnp.float64}
SETUPS = {
    "poisson2d32": (lambda dt: j_poisson2d(32).to_ell(dtype=dt),
                    tcfg.BENCH_AGGREGATION),
    "csky3d10": (lambda dt: j_csky3d(10).to_ell(dtype=dt,
                                                with_transpose=True),
                 tcfg.CSKY_AGGREGATION),
}
OMEGA = 2.0 / 3.0


def to_port(e):
    return interop.ell_from_numpy(
        np.asarray(e.cols), np.asarray(e.vals), np.asarray(e.rownnz),
        e.nrows, e.ncols, device="cpu",
        vals_t=None if e.vals_t is None else np.asarray(e.vals_t))


def ell_dict(e):
    return dict(cols=np.asarray(e.cols), vals=np.asarray(e.vals),
                rownnz=np.asarray(e.rownnz), nrows=e.nrows, ncols=e.ncols)


def bits(t, j):
    j = np.asarray(j)
    t = t.numpy()
    assert t.dtype == j.dtype and t.shape == j.shape
    np.testing.assert_array_equal(t.view(np.uint8), j.view(np.uint8))


def same_ell(t, j):
    """Equal shapes, columns and row lengths (int32 in the port; the JAX
    package's sums give int64 under x64), values bitwise."""
    assert (t.nrows, t.ncols, t.k, t.npad) == (j.nrows, j.ncols, j.k, j.npad)
    bits(t.cols, np.asarray(j.cols).astype(np.int32))
    bits(t.rownnz, np.asarray(j.rownnz).astype(np.int32))
    bits(t.vals, j.vals)


def rand_ell(n, m, density, seed, dt):
    rs = np.random.RandomState(seed)
    a = sp.random(n, m, density=density, random_state=rs, format="csr",
                  data_rvs=rs.randn)
    return JCSR.from_scipy(a).to_ell(dtype=DTYPES[dt])


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("case", ["square", "rectangular", "stencil",
                                  "growth"])
def test_spgemm_bitwise(case, dt):
    kc = None
    if case == "square":
        a, b = rand_ell(120, 120, 0.025, 0, dt), rand_ell(120, 120, 0.025,
                                                         10, dt)
    elif case == "rectangular":
        a, b = rand_ell(120, 80, 0.05, 3, dt), rand_ell(80, 50, 0.05, 4, dt)
    elif case == "stencil":
        a = b = j_poisson2d(20).to_ell(dtype=DTYPES[dt])
    else:
        # a first width far too small: it must grow, not truncate
        a = b = rand_ell(30, 30, 0.12, 7, dt)
        kc = 2
    t = tsp.spgemm_ell(to_port(a), to_port(b), kc=kc)
    j = jsp.spgemm_ell(a, b, kc=kc)
    same_ell(t, j)
    ref = (a.to_csr().to_scipy() @ b.to_csr().to_scipy()).toarray()
    np.testing.assert_allclose(t.to_csr().to_dense(), ref,
                               rtol=1e-5 if dt == "f32" else 1e-12,
                               atol=1e-5 if dt == "f32" else 1e-12)


def test_spgemm_shape_mismatch_raises():
    a = to_port(rand_ell(10, 9, 0.3, 0, "f64"))
    b = to_port(rand_ell(8, 10, 0.3, 1, "f64"))
    with pytest.raises(ValueError):
        tsp.spgemm_ell(a, b)


@pytest.mark.parametrize("dt", list(DTYPES))
def test_transpose_bitwise(dt):
    a = rand_ell(1500, 2100, 0.003, 9, dt)
    same_ell(tsp.transpose_ell(to_port(a)), jsp.transpose_ell(a))


def coarse_labels(a, seed):
    """A label vector of aggregates of one to four neighbouring rows, some
    rows excluded (-1)."""
    rs = np.random.RandomState(seed)
    n = a.nrows
    lab = np.full(a.npad, -1, np.int32)
    lab[:n] = np.arange(n) // 4
    lab[:n][rs.rand(n) < 0.05] = -1
    return lab, n // 4 + 1


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("problem", list(SETUPS))
def test_smoothed_prolongation_and_galerkin_bitwise(problem, dt):
    a = SETUPS[problem][0](DTYPES[dt])
    ta = to_port(a)
    lab, nc = coarse_labels(a, 1)
    tl = torch.from_numpy(lab)
    same_ell(tsm.tentative_p(tl, a.nrows, nc, ta.dtype),
             jsm.tentative_p(jnp.asarray(lab), a.nrows, nc)
             .astype(a.vals.dtype))
    # M = I − ω D⁻¹ A as the JAX package's smoothed_prolongation builds it
    d = jops.extract_diag(a)
    d_safe = jnp.where(d == 0.0, 1.0, d)
    isdiag = (a.cols == a.row_iota()) & a.slot_mask()
    mvals = (a.vals * (-OMEGA / d_safe)[None, :]
             + jnp.where(isdiag, 1.0, 0.0)).astype(a.vals.dtype)
    bits(tsm.jacobi_operator(ta, OMEGA).vals, mvals)
    tp = tsm.smoothed_prolongation(ta, tl, nc, OMEGA)
    jp = jsm.smoothed_prolongation(a, jnp.asarray(lab), nc, OMEGA)
    same_ell(tp, jp)
    assert not tp.rownnz.numpy()[lab < 0].any()
    tac, tpt = tsm.galerkin_general(ta, tp)
    jac, jpt = jsm.galerkin_general(a, jp)
    same_ell(tpt, jpt)
    same_ell(tac, jac)


@pytest.mark.parametrize("dt", list(DTYPES))
def test_weighted_transfers(dt):
    a = j_poisson2d(32).to_ell(dtype=DTYPES[dt])
    lab, nc = coarse_labels(a, 2)
    jp = jsm.smoothed_prolongation(a, jnp.asarray(lab), nc, OMEGA)
    _, jpt = jsm.galerkin_general(a, jp)
    nc_pad = (nc + 1023) // 1024 * 1024
    jplan = jtf.build_transfer_plan_from_p(jp, jpt, nc_pad)
    tplan = ttf.build_transfer_plan_from_p(to_port(jp), to_port(jpt), nc_pad)
    assert tplan.weighted and jplan.weighted
    rs = np.random.RandomState(3)
    xc = rs.rand(nc_pad).astype(np.dtype(DTYPES[dt]))
    v = rs.rand(a.npad).astype(np.dtype(DTYPES[dt]))
    tol = dict(rtol=1e-6, atol=1e-6) if dt == "f32" else dict(rtol=1e-12,
                                                             atol=1e-12)
    np.testing.assert_allclose(
        ttf.prolong_fast(tplan, torch.from_numpy(xc), a.npad).numpy(),
        np.asarray(jtf.prolong_fast(jplan, jnp.asarray(xc), a.npad)), **tol)
    np.testing.assert_allclose(
        ttf.restrict_fast(tplan, torch.from_numpy(v)).numpy(),
        np.asarray(jtf.restrict_fast(jplan, jnp.asarray(v))), **tol)


@pytest.fixture(scope="module")
def smoothed_ref():
    """Per problem: the JAX package's smooth_p setup (f32), its hierarchy's
    K-cycle count to 1e-6 on its weighted transfers, and the refreshed
    setups of both branches for A₁ = 1.7·A + 0.3·I."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MGS_NO_WARMSET", "1")
        for p, (make, agg) in SETUPS.items():
            a = make(jnp.float32)
            s = jagg.build_amg_setup(a, HierarchyConfig(
                max_coarse_size=512, smooth_p=OMEGA,
                aggregation=AggregationConfig(**agg)))
            h = j_build(s.matrices[0], s.level_labels, s.matrices[1:],
                        p_ops=s.p_ops, pt_ops=s.pt_ops,
                        **tcfg.BENCH_HIERARCHY)
            b = np.random.RandomState(0).rand(a.nrows)
            res = j_solve(h, b, method="bicgstab", tol=1e-6, maxiter=200)
            out[p] = dict(a=a, setup=s, b=b, iterations=int(res.iterations),
                          status=int(res.status))
        a = out["poisson2d32"]["a"]
        a1 = dataclasses.replace(a, vals=refreshed_vals(a))
        out["refresh"] = dict(
            smoothed=jagg.refresh_setup(out["poisson2d32"]["setup"], a1),
            plain=jagg.refresh_setup(jagg.build_amg_setup(
                a, HierarchyConfig(max_coarse_size=512,
                                   aggregation=AggregationConfig(
                                       **tcfg.BENCH_AGGREGATION))), a1))
    return out


def refreshed_vals(a):
    isdiag = (a.cols == a.row_iota()) & a.slot_mask()
    return (jnp.float32(1.7) * a.vals
            + jnp.where(isdiag, jnp.float32(0.3), jnp.float32(0.0)))


def port_smoothed_setup(problem, a):
    return tagg.build_amg_setup(to_port(a), tcfg.HierarchyConfig(
        max_coarse_size=512, smooth_p=OMEGA,
        aggregation=tcfg.AggregationConfig(**SETUPS[problem][1])))


@pytest.mark.parametrize("problem", list(SETUPS))
def test_smooth_p_setup_bitwise_and_count(smoothed_ref, problem):
    r = smoothed_ref[problem]
    js = r["setup"]
    ts = port_smoothed_setup(problem, r["a"])
    assert [m.nrows for m in ts.matrices] == [m.nrows for m in js.matrices]
    assert ts.smooth_omega == js.smooth_omega == OMEGA
    for tl, jl in zip(ts.level_labels, js.level_labels):
        bits(tl, jl)
    for tm, jm in zip(ts.matrices[1:], js.matrices[1:]):
        same_ell(tm, jm)
    for tops, jops_ in ((ts.p_ops, js.p_ops), (ts.pt_ops, js.pt_ops)):
        assert len(tops) == len(jops_) == len(ts.level_labels)
        for t, j in zip(tops, jops_):
            same_ell(t, j)
    h = build_hierarchy(ts.matrices[0], ts.level_labels, ts.matrices[1:],
                        p_ops=ts.p_ops, pt_ops=ts.pt_ops,
                        **tcfg.BENCH_HIERARCHY)
    assert all(lvl.tplan.weighted for lvl in h.levels)
    res = solve_hierarchy(h, r["b"], method="bicgstab", tol=1e-6,
                          maxiter=200)
    assert res.status == 0 == r["status"]
    assert res.iterations == r["iterations"]
    # the JAX setup carried over through interop gives the same count
    hj = interop.hierarchy_from_numpy(
        [ell_dict(m) for m in js.matrices],
        [np.asarray(l) for l in js.level_labels], device="cpu",
        p_ops=[ell_dict(p) for p in js.p_ops],
        pt_ops=[ell_dict(p) for p in js.pt_ops], **tcfg.BENCH_HIERARCHY)
    assert solve_hierarchy(hj, r["b"], method="bicgstab", tol=1e-6,
                           maxiter=200).iterations == r["iterations"]


@pytest.mark.parametrize("branch", ["plain", "smoothed"])
def test_refresh_setup_bitwise(smoothed_ref, branch):
    a = smoothed_ref["poisson2d32"]["a"]
    if branch == "smoothed":
        prev = port_smoothed_setup("poisson2d32", a)
    else:
        prev = tagg.build_amg_setup(to_port(a), tcfg.bench_config())
    ta1 = dataclasses.replace(to_port(a), vals=torch.from_numpy(
        np.asarray(refreshed_vals(a))))
    ts = tagg.refresh_setup(prev, ta1)
    js = smoothed_ref["refresh"][branch]
    assert len(ts.matrices) == len(js.matrices)
    for tm, jm in zip(ts.matrices, js.matrices):
        same_ell(tm, jm)
    if branch == "smoothed":
        for t, j in zip(ts.p_ops + ts.pt_ops, js.p_ops + js.pt_ops):
            same_ell(t, j)
    else:
        assert ts.p_ops is None
    with pytest.raises(ValueError):
        tagg.refresh_setup(prev, to_port(j_poisson2d(16).to_ell(
            dtype=jnp.float32)))


def test_shard_hierarchy_refuses_weighted_plan(smoothed_ref):
    js = smoothed_ref["poisson2d32"]["setup"]
    h = interop.hierarchy_from_numpy(
        [ell_dict(m) for m in js.matrices],
        [np.asarray(l) for l in js.level_labels], device="cpu",
        p_ops=[ell_dict(p) for p in js.p_ops],
        pt_ops=[ell_dict(p) for p in js.pt_ops], **tcfg.BENCH_HIERARCHY)
    with pytest.raises(NotImplementedError, match="weighted"):
        shard_hierarchy(h, RowMesh(4, "cpu"))
