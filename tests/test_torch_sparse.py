"""The port's data layer against the JAX package: generators, ELL packing,
sparse ops, the DIA+ELL hybrid split and its SpMV (K1's plain version;
plan-free path, on the CPU)."""
import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from multigridsolver_tpu.cli import generators as jgen
from multigridsolver_tpu.setup.aggregation import build_amg_setup
from multigridsolver_tpu.sparse import hybrid as jhyb
from multigridsolver_tpu.sparse import ops as jops
from multigridsolver_tpu.utils.config import (AggregationConfig,
                                              HierarchyConfig)
from multigridsolver_tpu_torch.cli import generators as tgen
from multigridsolver_tpu_torch.interop import ell_from_numpy
from multigridsolver_tpu_torch.ops import gather as g
from multigridsolver_tpu_torch.sparse import hybrid as thyb
from multigridsolver_tpu_torch.sparse import ops as tops

DTYPES = {"f32": (jnp.float32, torch.float32), "f64": (jnp.float64,
                                                        torch.float64)}
PROBLEMS = {"poisson2d_40": lambda g: g.poisson2d(40),
            "csky3d_10": lambda g: g.csky3d(10)}


def to_port(e):
    """The port's ELL holding a JAX ELL's arrays."""
    return ell_from_numpy(np.asarray(e.cols), np.asarray(e.vals),
                          np.asarray(e.rownnz), e.nrows, e.ncols,
                          device="cpu")


@pytest.fixture(scope="module")
def coarse_levels():
    """The JAX setup's operators on poisson2d(64) in f64 (levels with an
    ELL remainder after the DIA split)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MGS_NO_WARMSET", "1")
        cfg = HierarchyConfig(max_coarse_size=512, aggregation=AggregationConfig(
            ktg=10.0, npass=2, tou=8.0, symmetric=True))
        s = build_amg_setup(jgen.poisson2d(64).to_ell(dtype=jnp.float64), cfg)
    return s.matrices


@pytest.mark.parametrize("name", ["poisson2d_40", "csky2d_10", "csky3d_10"])
def test_generators_entry_exact(name):
    make = {"poisson2d_40": lambda g: g.poisson2d(40),
            "csky2d_10": lambda g: g.csky2d(10),
            "csky3d_10": lambda g: g.csky3d(10)}[name]
    a, b = make(jgen), make(tgen)
    assert a.shape == b.shape
    np.testing.assert_array_equal(a.indptr, b.indptr)
    np.testing.assert_array_equal(a.indices, b.indices)
    np.testing.assert_array_equal(a.data, b.data)


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("name", list(PROBLEMS))
def test_to_ell_bitwise(name, dt):
    jdt, tdt = DTYPES[dt]
    je = PROBLEMS[name](jgen).to_ell(dtype=jdt)
    te = PROBLEMS[name](tgen).to_ell(dtype=tdt, device="cpu")
    assert (te.nrows, te.ncols, te.k, te.npad) == (je.nrows, je.ncols, je.k,
                                                   je.npad)
    assert te.npad % 1024 == 0
    assert te.cols.dtype == torch.int32 and te.rownnz.dtype == torch.int32
    np.testing.assert_array_equal(te.cols.numpy(), np.asarray(je.cols))
    np.testing.assert_array_equal(te.vals.numpy(), np.asarray(je.vals))
    np.testing.assert_array_equal(te.rownnz.numpy(), np.asarray(je.rownnz))
    np.testing.assert_array_equal(te.slot_mask().numpy(),
                                  np.asarray(je.slot_mask()))
    np.testing.assert_array_equal(te.row_mask().numpy(),
                                  np.asarray(je.row_mask()))
    assert te.nnz == je.nnz


def test_entry_points_default_to_the_card():
    """With no device given, the entry points place their tensors on the card;
    where there is none they raise instead of building on the CPU."""
    from multigridsolver_tpu_torch.solve.api import pad_vector
    a = tgen.poisson2d(8)
    if torch.cuda.is_available():
        assert a.to_ell().device.type == "cuda"
        assert pad_vector(np.ones(3), 8, torch.float32).device.type == "cuda"
        return
    with pytest.raises((AssertionError, RuntimeError)):
        a.to_ell()
    with pytest.raises((AssertionError, RuntimeError)):
        pad_vector(np.ones(3), 8, torch.float32)
    e = a.to_ell(dtype=torch.float64, device="cpu")
    with pytest.raises((AssertionError, RuntimeError)):
        ell_from_numpy(e.cols.numpy(), e.vals.numpy(), e.rownnz.numpy(),
                       e.nrows, e.ncols)


def test_to_csr_roundtrip():
    a = tgen.csky3d(10)
    back = a.to_ell(dtype=torch.float64, device="cpu").to_csr()
    np.testing.assert_array_equal(back.indptr, a.indptr)
    np.testing.assert_array_equal(back.indices, a.indices)
    np.testing.assert_array_equal(back.data, a.data)


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("name", list(PROBLEMS))
def test_ell_spmv_matches_jax(name, dt):
    jdt, tdt = DTYPES[dt]
    je = PROBLEMS[name](jgen).to_ell(dtype=jdt)
    te = PROBLEMS[name](tgen).to_ell(dtype=tdt, device="cpu")
    x = np.random.RandomState(0).rand(je.npad)
    y_j = np.asarray(jops.spmv(je, jnp.asarray(x, jdt)))
    y_t = tops.spmv(te, torch.from_numpy(x).to(tdt)).numpy()
    rtol = 1e-6 if dt == "f32" else 1e-12
    np.testing.assert_allclose(y_t, y_j, rtol=rtol, atol=rtol)


def test_row_col_diag_dense_match_jax():
    a = jgen.csky3d(10)                 # nonsymmetric: col sums ≠ row sums
    je = a.to_ell(dtype=jnp.float64)
    te = tgen.csky3d(10).to_ell(dtype=torch.float64, device="cpu")
    np.testing.assert_array_equal(tops.extract_diag(te).numpy(),
                                  np.asarray(jops.extract_diag(je)))
    for absolute in (False, True):
        for skip in (False, True):
            np.testing.assert_allclose(
                tops.row_sum(te, absolute, skip).numpy(),
                np.asarray(jops.row_sum(je, absolute, skip)), rtol=1e-13)
            np.testing.assert_allclose(
                tops.col_sum(te, absolute, skip).numpy(),
                np.asarray(jops.col_sum(je, absolute, skip)), rtol=1e-13)
    np.testing.assert_array_equal(tops.to_dense(te).numpy(), a.to_dense())


def test_take_neighbor_and_member_rows_match_jax_on_valid_slots():
    je = jgen.poisson2d(40).to_ell(dtype=jnp.float32)
    te = to_port(je)
    rs = np.random.RandomState(1)
    valid = np.asarray(je.slot_mask())
    for x in (rs.rand(je.npad).astype(np.float32),
              rs.randint(-1, 100, je.npad).astype(np.int32),
              rs.rand(je.npad) < 0.5):
        out_t = tops.take_neighbor(te, torch.from_numpy(x)).numpy()
        out_j = np.asarray(jops.take_neighbor(je, jnp.asarray(x)))
        assert out_t.dtype == out_j.dtype
        np.testing.assert_array_equal(out_t[valid], out_j[valid])
    members = rs.randint(0, je.npad, 2048).astype(np.int32)
    xs = rs.rand(5, je.npad)
    np.testing.assert_array_equal(
        tops.take_member_rows(torch.from_numpy(members),
                              torch.from_numpy(xs)).numpy(),
        np.asarray(jops.take_member_rows(jnp.asarray(members),
                                         jnp.asarray(xs), None, None, None)))


@pytest.mark.parametrize("level", [0, 1, 2])
def test_hybrid_split_matches_jax(coarse_levels, level):
    je = coarse_levels[level]
    jh = jhyb.hybrid_from_ell_device(je)
    th = thyb.hybrid_from_ell(to_port(je))
    assert th.offsets == jh.offsets
    np.testing.assert_array_equal(th.dvals.numpy(), np.asarray(jh.dvals))
    assert (th.ell is None) == (jh.ell is None)
    if th.ell is not None:
        np.testing.assert_array_equal(th.ell.cols.numpy(),
                                      np.asarray(jh.ell.cols))
        np.testing.assert_array_equal(th.ell.vals.numpy(),
                                      np.asarray(jh.ell.vals))
        np.testing.assert_array_equal(th.ell.rownnz.numpy(),
                                      np.asarray(jh.ell.rownnz))
    x = np.random.RandomState(level).rand(je.npad)
    np.testing.assert_allclose(
        thyb.spmv(th, torch.from_numpy(x)).numpy(),
        np.asarray(jhyb.spmv(jh, jnp.asarray(x))), rtol=1e-12, atol=1e-12)
    np.testing.assert_array_equal(thyb.extract_diag(th).numpy(),
                                  np.asarray(jhyb.extract_diag(jh)))
    np.testing.assert_allclose(thyb.row_sum_abs_offdiag(th).numpy(),
                               np.asarray(jhyb.row_sum_abs_offdiag(jh)),
                               rtol=1e-13)


def test_hybrid_with_remainder_exists(coarse_levels):
    """The coarse levels exercise the K1 remainder path."""
    assert any(thyb.hybrid_from_ell(to_port(m)).ell is not None
               for m in coarse_levels[1:])


def old_lane_loop(h, x):
    """The hybrid SpMV as the port computed it before K1 took the lanes:
    a multiply and an add per DIA lane, then the remainder's SpMV and one
    add."""
    n = h.npad
    y = torch.zeros((n,), dtype=x.dtype)
    for d, o in enumerate(h.offsets):
        lo, hi = max(0, -o), min(n, n - o)
        y[lo:hi].add_(h.dvals[d, lo:hi] * x[lo + o:hi + o])
    if h.ell is not None:
        y.add_(tops.spmv(h.ell, x)[:n])
    return y


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("level", [0, 1, 2])
def test_hyb_spmv_plain_matches_old_loop_and_jax(coarse_levels, level, dt):
    """K1's plain version on the JAX setup's levels: bitwise the old lane
    loop, and JAX's plan-free hybrid SpMV to rtol 1e-6 (f32) / 1e-12
    (f64)."""
    jdt, tdt = DTYPES[dt]
    je = coarse_levels[level].astype(jdt)
    th = thyb.hybrid_from_ell(to_port(je))
    assert th.lanes.offsets == th.offsets
    x = np.random.RandomState(level).rand(je.npad)
    tx = torch.from_numpy(x).to(tdt)
    e = th.ell
    y = g.hyb_spmv(th.dvals, th.lanes, None if e is None else e.cols,
                   None if e is None else e.vals, tx)
    assert torch.equal(y, old_lane_loop(th, tx))
    assert torch.equal(thyb.spmv(th, tx), y)
    # the split only moves values, so JAX's f64 split cast to f32 is its
    # f32 split (and reuses the f64 split's compiled programs)
    jh = jhyb.hybrid_from_ell_device(coarse_levels[level])
    jh = dataclasses.replace(
        jh, dvals=jh.dvals.astype(jdt),
        ell=None if jh.ell is None else jh.ell.astype(jdt))
    y_j = np.asarray(jhyb.spmv(jh, jnp.asarray(x, jdt)))
    tol = 1e-6 if dt == "f32" else 1e-12
    np.testing.assert_allclose(y.numpy(), y_j, rtol=tol, atol=tol)


@pytest.mark.parametrize("case", ["no_lanes", "no_remainder", "far_offsets",
                                  "padding_rows"])
def test_hyb_spmv_edge_cases(case):
    rs = np.random.RandomState(7)
    if case == "no_lanes":
        # D = 0 is the plain ELL SpMV of gather_spmv
        te = tgen.csky3d(10).to_ell(dtype=torch.float64, device="cpu")
        x = torch.from_numpy(rs.rand(te.npad))
        y = g.hyb_spmv(torch.zeros((0, te.npad), dtype=torch.float64),
                       g.NO_LANES, te.cols, te.vals, x)
        assert torch.equal(y, g.gather_spmv_plain(te.cols, te.vals, x))
        return
    if case == "far_offsets":
        # |o| = npad - 1: lane o reads one row only; the others are
        # skipped whatever dvals holds there
        npad = 1024
        offs = (-(npad - 1), -3, 0, npad - 1)
        dv = rs.rand(len(offs), npad)
        x = rs.rand(npad)
        dense = np.zeros((npad, npad))
        for d, o in enumerate(offs):
            i = np.arange(max(0, -o), min(npad, npad - o))
            dense[i, i + o] = dv[d, i]
        y = g.hyb_spmv(torch.from_numpy(dv), g.pack_lanes(offs), None, None,
                       torch.from_numpy(x))
        np.testing.assert_allclose(y.numpy(), dense @ x, rtol=1e-12,
                                   atol=1e-12)
        return
    # poisson2d(40): five lanes, no remainder, rows 1600..2047 padding
    a = tgen.poisson2d(40)
    th = thyb.hybrid_from_ell(a.to_ell(dtype=torch.float64, device="cpu"))
    assert th.ell is None and len(th.offsets) == 5
    x = rs.rand(th.npad)
    y = thyb.spmv(th, torch.from_numpy(x)).numpy()
    if case == "no_remainder":
        jh = jhyb.hybrid_from_ell_device(
            jgen.poisson2d(40).to_ell(dtype=jnp.float64))
        np.testing.assert_allclose(y, np.asarray(jhyb.spmv(
            jh, jnp.asarray(x))), rtol=1e-12, atol=1e-12)
    else:
        np.testing.assert_array_equal(y[a.nrows:], 0.0)
        np.testing.assert_allclose(y[:a.nrows], a.to_scipy() @ x[:a.nrows],
                                   rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("fault", ["too_many_lanes", "mixed_dtypes",
                                   "noncontiguous_dvals"])
def test_hyb_spmv_rejects(fault):
    npad = 1024
    x = torch.zeros(npad, dtype=torch.float64)
    lanes = g.pack_lanes((-1, 0, 1))
    dv = torch.zeros((3, npad), dtype=torch.float64)
    with pytest.raises(ValueError):
        if fault == "too_many_lanes":
            g.pack_lanes(range(g.MAX_LANES + 1))
        elif fault == "mixed_dtypes":
            g.hyb_spmv(dv.float(), lanes, None, None, x)
        else:
            g.hyb_spmv(torch.zeros((npad, 3), dtype=torch.float64).T, lanes,
                       None, None, x)
    if fault == "too_many_lanes":
        with pytest.raises(ValueError):
            g.hyb_spmv(torch.zeros((g.MAX_LANES + 1, npad),
                                   dtype=torch.float64),
                       g.pack_lanes(range(g.MAX_LANES)), None, None, x)
    elif fault == "mixed_dtypes":
        cols = torch.zeros((2, npad), dtype=torch.int32)
        with pytest.raises(ValueError):
            g.hyb_spmv(dv, lanes, cols, torch.zeros((2, npad)), x)
