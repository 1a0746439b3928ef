"""The port's ILU(0) smoother against the plain reference
(``ilu_reference.py``, plain PyTorch in float64): the Chow–Patel factors
at poisson2d(16) and csky3d(6), their fixed point against the sequential
IKJ ILU(0), the truncated-Neumann application, an ilu0 K-cycle BiCGStab
solve against a dense solve, and the tracer's ilu0 spans and counter."""
import contextlib
import io

import numpy as np
import pytest
import torch

import ilu_reference as ref
from multigridsolver_tpu_torch.cli.generators import csky3d, poisson2d
from multigridsolver_tpu_torch.setup.aggregation import build_amg_setup
from multigridsolver_tpu_torch.solve import smoothers as sm
from multigridsolver_tpu_torch.solve.api import solve_hierarchy
from multigridsolver_tpu_torch.solve.hierarchy import build_hierarchy
from multigridsolver_tpu_torch.sparse import hybrid
from multigridsolver_tpu_torch.utils import timing
from multigridsolver_tpu_torch.utils.config import (AggregationConfig,
                                                    HierarchyConfig)

PROBLEMS = {"poisson2d16": lambda: poisson2d(16),
            "csky3d6": lambda: csky3d(6)}
# the benchmark configuration poisson2000ilu0's hierarchy
ILU0 = dict(smoother_kind="ilu0", cycle="kcycle", kcycle_depth=3,
            pre_smooth=1, post_smooth=1, sweeps=2, inner_sweeps=2,
            factor_sweeps=5)
# each float32 factor sums at most K products of float32 numbers
RTOL_F32 = 1e-5


def on_pattern(ell, lvals, uvals, udiag, indptr, indices):
    """The port's factors as one value per stored entry of the CSR
    pattern (L where col < row, U where col ≥ row), in float64."""
    n = ell.nrows
    mask = ell.slot_mask() & ell.row_mask()[None, :]
    rows = ell.row_iota()[mask].long()
    cols = ell.cols[mask].long()
    vals = torch.where(cols < rows, lvals[mask], uvals[mask]).double()
    keys = ref.entry_rows(indptr) * n + indices
    pos = torch.searchsorted(keys, rows * n + cols)
    assert torch.equal(keys[pos], rows * n + cols)
    out = torch.zeros(keys.numel(), dtype=torch.float64)
    out[pos] = vals
    diag = indices == ref.entry_rows(indptr)
    out[diag] = udiag.double()[: n][ref.entry_rows(indptr)[diag]]
    return out


def case(name, dtype):
    m = PROBLEMS[name]()
    ell = m.to_ell(dtype=dtype, device="cpu")
    return m, ell, ref.csr_arrays(m.to_scipy())


def exceeds(got, want, rtol):
    return bool(((got - want).abs() > rtol * want.abs()).any())


@pytest.mark.parametrize("name", list(PROBLEMS))
def test_factors_match_plain_chow_patel(name):
    """Five float32 sweeps against the plain sweeps in float64, entry by
    entry; the plain sweeps in bfloat16 fail the same tolerance."""
    _, ell, (ip, ix, v) = case(name, torch.float32)
    got = on_pattern(ell, *sm.ilu0_factor(ell, sweeps=5), ip, ix)
    trip = ref.triples(ip, ix)
    want = ref.chow_patel(ip, ix, v, 5, trip=trip)
    assert not exceeds(got, want, RTOL_F32)
    low = ref.chow_patel(ip, ix, v, 5, dtype=torch.bfloat16, trip=trip)
    assert exceeds(low.double(), want, RTOL_F32)


@pytest.mark.parametrize("name", list(PROBLEMS))
def test_forty_sweeps_reach_the_ikj_ilu0(name):
    """The Chow–Patel fixed point, the port's and the plain one, is the
    sequential IKJ ILU(0)."""
    _, ell, (ip, ix, v) = case(name, torch.float64)
    ikj = ref.ikj_ilu0(ip, ix, v)
    got = on_pattern(ell, *sm.ilu0_factor(ell, sweeps=40), ip, ix)
    torch.testing.assert_close(got, ikj, rtol=1e-10, atol=0)
    torch.testing.assert_close(ref.chow_patel(ip, ix, v, 40), ikj,
                               rtol=1e-12, atol=0)


@pytest.mark.parametrize("dtype,rtol", [(torch.float32, RTOL_F32),
                                        (torch.float64, 1e-12)])
@pytest.mark.parametrize("name", list(PROBLEMS))
def test_ilu_apply_matches_plain_neumann(name, dtype, rtol):
    """``Smoother.apply`` (the level's hybrid for A, the factors' plain
    ELLs) against the plain truncated-Neumann application on the same
    factors; with n Neumann terms the plain application is exact."""
    _, ell, (ip, ix, v) = case(name, dtype)
    s = sm.make_smoother(hybrid.hybrid_from_ell(ell), kind="ilu0", ell=ell,
                         sweeps=2, inner_sweeps=2)
    n = ell.nrows
    gen = torch.Generator().manual_seed(11)
    b = torch.zeros(ell.npad, dtype=dtype)
    x = torch.zeros(ell.npad, dtype=dtype)
    b[:n] = torch.rand(n, generator=gen, dtype=torch.float64).to(dtype)
    x[:n] = torch.rand(n, generator=gen, dtype=torch.float64).to(dtype)
    got = s.apply(hybrid.hybrid_from_ell(ell), b, x)[:n].double()
    w = on_pattern(ell, s.lmat.vals, s.umat.vals, s.udiag, ip, ix)
    want = ref.neumann_apply(ip, ix, v, w, b[:n].double(), x[:n].double(),
                             2, 2)
    torch.testing.assert_close(got, want, rtol=rtol,
                               atol=rtol * float(want.abs().max()))
    exact = ref.exact_apply(ip, ix, v, w, b[:n].double(), x[:n].double(), 2)
    torch.testing.assert_close(
        ref.neumann_apply(ip, ix, v, w, b[:n].double(), x[:n].double(), 2,
                          n), exact, rtol=1e-9, atol=0)


def kcycle(grid=32, dtype=torch.float64):
    ell = poisson2d(grid).to_ell(dtype=dtype, device="cpu")
    agg = AggregationConfig(ktg=10.0, npass=2, tou=8.0, symmetric=True)
    setup = build_amg_setup(ell, HierarchyConfig(max_coarse_size=8,
                                                 aggregation=agg))
    return build_hierarchy(setup.matrices[0], setup.level_labels,
                           setup.matrices[1:], **ILU0)


def test_ilu0_kcycle_bicgstab_solve_against_dense():
    """BiCGStab to 1e-10 with the ilu0 K-cycle at poisson2d(32), x
    against numpy's dense float64 solve."""
    hier = kcycle()
    assert len(hier.levels) >= 3
    n = 32 * 32
    b = torch.rand(n, dtype=torch.float64,
                   generator=torch.Generator().manual_seed(4))
    res = solve_hierarchy(hier, b, tol=1e-10)
    assert res.status == 0 and res.iterations <= 12
    want = np.linalg.solve(poisson2d(32).to_dense(), b.numpy())
    x = res.x[:n].numpy()
    assert np.abs(x - want).max() <= 1e-8 * np.abs(want).max()


def test_ilu0_spans_and_counter_leave_results_bitwise():
    """``ilu0.factor`` once a level of the build, ``smooth`` twice a
    level visit (pre and post) and ``ilu0.tri_spmv`` 2·inner·sweeps an
    application; the build's factors and the solve's x bitwise those of
    an untraced run; the report prints them."""
    b = torch.rand(32 * 32, dtype=torch.float64,
                   generator=torch.Generator().manual_seed(8))
    plain_h = kcycle()
    plain = solve_hierarchy(plain_h, b, tol=1e-8)
    tracer = timing.PhaseTimer(device_spans=("ilu0.factor",))
    with timing.tracing(tracer):
        hier = kcycle()
        traced = solve_hierarchy(hier, b, tol=1e-8)
    nl = len(hier.levels)
    assert [tracer.counts[("ilu0.factor", l)] for l in range(nl)] == [1] * nl
    for l in range(nl):
        assert tracer.counts[("smooth", l)] == 2 * tracer.counts[("level", l)]
    applications = sum(tracer.counts[("smooth", l)] for l in range(nl))
    assert tracer.counters["ilu0.tri_spmv"] == 2 * 2 * 2 * applications
    # device spans only on a card
    assert tracer.events == [] and tracer.device_seconds("ilu0.factor") == {}
    for lt, lp in zip(hier.levels, plain_h.levels):
        assert torch.equal(lt.smoother.lmat.vals, lp.smoother.lmat.vals)
        assert torch.equal(lt.smoother.umat.vals, lp.smoother.umat.vals)
        assert torch.equal(lt.smoother.udiag, lp.smoother.udiag)
    assert torch.equal(traced.x, plain.x)
    assert traced.iterations == plain.iterations
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        tracer.report()
    text = err.getvalue()
    assert "ilu0.factor 0 (x1)" in text and "smooth 0 (x" in text
    assert "ilu0.tri_spmv" in text
