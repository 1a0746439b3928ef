"""The port's checktentagg (``setup/tentagg.py``) and its checked pass
against the JAX package's plan-free path (CPU) and against
``tests/test_tentagg.py``'s numpy transcription of the Fortran:
``member_ranks`` for km 2/4/8, the verdicts bitwise on the Laplacian and
indefinite cases (km 2) and on csky3d(10)'s real merges (km 2 and 4),
the checked pass's pairing and labels on csky3d(10) and poisson2d(32),
and ``build_amg_setup(check_tentagg=True)`` on csky3d(20) f32: levels and
labels bitwise and the same BiCGStab count."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import scipy.sparse as sp
import torch

from test_tentagg import build_case, ref_checktentagg
from multigridsolver_tpu.cli.generators import csky3d as j_csky3d
from multigridsolver_tpu.cli.generators import poisson2d as j_poisson2d
from multigridsolver_tpu.setup import aggregation as jagg
from multigridsolver_tpu.setup import tentagg as jtg
from multigridsolver_tpu.solve.api import solve_hierarchy as j_solve
from multigridsolver_tpu.solve.hierarchy import build_hierarchy as j_build
from multigridsolver_tpu.sparse.formats import CSR as JCSR
from multigridsolver_tpu.utils.config import (AggregationConfig,
                                              HierarchyConfig)
from multigridsolver_tpu_torch import interop
from multigridsolver_tpu_torch.setup import aggregation as tagg
from multigridsolver_tpu_torch.setup import tentagg as ttg
from multigridsolver_tpu_torch.setup.galerkin import galerkin_pair_ell
from multigridsolver_tpu_torch.setup.matching import mutual_match
from multigridsolver_tpu_torch.setup.strength import compute_strength
from multigridsolver_tpu_torch.solve.api import solve_hierarchy
from multigridsolver_tpu_torch.solve.hierarchy import build_hierarchy
from multigridsolver_tpu_torch.utils import config as tcfg

j_check_jit = jax.jit(jtg.checktentagg, static_argnames=("ktg", "km"))
PASS_CASES = {
    "csky3d10": (lambda: j_csky3d(10).to_ell(dtype=jnp.float32,
                                             with_transpose=True),
                 tcfg.CSKY_AGGREGATION),
    "poisson2d32": (lambda: j_poisson2d(32).to_ell(dtype=jnp.float32),
                    tcfg.BENCH_AGGREGATION),
}


def to_port(e):
    return interop.ell_from_numpy(
        np.asarray(e.cols), np.asarray(e.vals), np.asarray(e.rownnz),
        e.nrows, e.ncols, device="cpu",
        vals_t=None if e.vals_t is None else np.asarray(e.vals_t))


def to_jax(t):
    from multigridsolver_tpu.sparse.formats import ELL as JELL
    return JELL(cols=jnp.asarray(t.cols.numpy()),
                vals=jnp.asarray(t.vals.numpy()),
                rownnz=jnp.asarray(t.rownnz.numpy()), nrows=t.nrows,
                ncols=t.ncols,
                vals_t=None if t.vals_t is None
                else jnp.asarray(t.vals_t.numpy()))


def bits(t, j):
    j = np.asarray(j)
    t = t.numpy()
    assert t.dtype == j.dtype and t.shape == j.shape
    np.testing.assert_array_equal(t.view(np.uint8), j.view(np.uint8))


@pytest.mark.parametrize("km", [2, 4, 8])
def test_member_ranks_bitwise(km):
    rs = np.random.RandomState(km)
    labels = rs.randint(-1, 300, 2048).astype(np.int32)
    bits(ttg.member_ranks(torch.from_numpy(labels), km),
         jtg.member_ranks(jnp.asarray(labels), km))


@pytest.mark.parametrize("ktg,indefinite", [(8.0, False), (4.0, True)])
def test_verdicts_against_fortran_and_jax(ktg, indefinite):
    """``tests/test_tentagg.py``'s cases: consecutive pairs merged pairwise
    on a 1-D Laplacian, with positive off-diagonals sprinkled in for the
    indefinite case."""
    a_dense = build_case(64, indefinite=indefinite)
    n = a_dense.shape[0]
    ell = JCSR.from_scipy(sp.csr_matrix(a_dense)).to_ell(
        row_pad=8, dtype=jnp.float64)
    labels = np.full(ell.npad, -1, np.int32)
    labels[:n] = np.arange(n) // 2
    nc = n // 2
    paired = np.full(((nc + 7) // 8) * 8, -1, np.int32)
    paired[:nc] = np.arange(nc) ^ 1
    si = np.zeros(ell.npad)
    si[:n] = -(a_dense.sum(axis=1) - np.diag(a_dense))
    ac_dense = np.zeros((nc, nc))
    np.add.at(ac_dense, (labels[:n, None].repeat(n, 1),
                         labels[None, :n].repeat(n, 0)), a_dense)
    ac = JCSR.from_scipy(sp.csr_matrix(ac_dense)).to_ell(
        row_pad=8, dtype=jnp.float64)
    jacc = j_check_jit(ell, jnp.asarray(si), jnp.asarray(labels), ac,
                       jnp.asarray(paired), ktg=ktg,
                       zerors=jnp.asarray(False), km=2)
    log = []
    tacc = ttg.checktentagg(to_port(ell), torch.from_numpy(si),
                            torch.from_numpy(labels), to_port(ac),
                            torch.from_numpy(paired), ktg,
                            torch.tensor(False), 2, log=log)
    bits(tacc, jacc)
    fortran = np.ones(nc, bool)
    for c in range(0, nc - 1, 2):
        members = [i for i in range(n) if labels[i] in (c, c + 1)]
        fortran[c] = fortran[c + 1] = ref_checktentagg(a_dense, si, members,
                                                       ktg, False)
    np.testing.assert_array_equal(tacc.numpy()[:nc], fortran)
    assert fortran.all() != indefinite
    assert int(log[0]["pairs"]) == nc // 2
    assert int(log[0]["rejected"]) == int((~fortran[::2]).sum())


@pytest.fixture(scope="module")
def csky_pass2():
    """csky3d(10) f32: the first pass, its coarse operator and the second
    pass's strength (the port's, bitwise the JAX package's per
    ``tests/test_torch_nonsym.py``)."""
    ja = j_csky3d(10).to_ell(dtype=jnp.float32, with_transpose=True)
    a = to_port(ja)
    cfg = tcfg.AggregationConfig(**tcfg.CSKY_AGGREGATION)
    paired, labels, nc, st = tagg.match_pass(a, True, cfg)
    ac, _ = galerkin_pair_ell(a, paired, labels, nc)
    st2 = compute_strength(ac, cfg.ktg, False, checkdd=cfg.checkdd,
                           trspos=cfg.trspos, fracnegrcsum=cfg.fracnegrcsum)
    return dict(ja=ja, a=a, labels=labels, st=st, ac=ac, st2=st2)


@pytest.mark.parametrize("km", [2, 4])
def test_verdicts_on_real_merges_bitwise(csky_pass2, km):
    """Every tentative merge of csky3d(10)'s second pass, W in float32
    with many pivots within rounding of 0; km = 4 tests 8×8 blocks with
    the same merges (the ranks' slots past 2 stay empty)."""
    c = csky_pass2
    paired = mutual_match(c["ac"], c["st2"])
    log = []
    tacc = ttg.checktentagg(c["a"], c["st"].si, c["labels"], c["ac"],
                            paired, 10.0, c["st"].zerors, km, log=log)
    jacc = j_check_jit(c["ja"], jnp.asarray(c["st"].si.numpy()),
                       jnp.asarray(c["labels"].numpy()), to_jax(c["ac"]),
                       jnp.asarray(paired.numpy()), ktg=10.0,
                       zerors=jnp.asarray(bool(c["st"].zerors)), km=km)
    bits(tacc, jacc)
    assert 0 < int(log[0]["rejected"]) < int(log[0]["pairs"])


@pytest.mark.parametrize("problem", list(PASS_CASES))
def test_checked_pass_bitwise(problem):
    """The checked further pass (three match → check → drop rounds, then
    singletons) on the first pass's coarse operator: pairing, labels and
    nc equal to the JAX package's ``_match_pass_checked``."""
    make, agg = PASS_CASES[problem]
    ja = make()
    a = to_port(ja)
    cfg = tcfg.AggregationConfig(**agg, check_tentagg=True)
    paired, labels, nc, st = tagg.match_pass(a, True, cfg)
    ac, _ = galerkin_pair_ell(a, paired, labels, nc)
    tp, tl, tnc, checks = tagg.match_pass_checked(ac, a, st.si, labels,
                                                  st.zerors, cfg, 2)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MGS_NO_WARMSET", "1")
        jp, jl, packed = jagg._match_pass_checked(
            to_jax(ac), ja, jnp.asarray(st.si.numpy()),
            jnp.asarray(labels.numpy()), jnp.asarray(bool(st.zerors)),
            float(cfg.ktg), float(cfg.checkdd), float(cfg.trspos),
            float(cfg.fracnegrcsum), int(cfg.max_matching_rounds),
            bool(cfg.symmetric), str(cfg.mu_mode), 2)
    bits(tp, jp)
    bits(tl, jl)
    assert tnc == int(packed[0])
    assert len(checks) == tagg.CHECK_RETRIES
    assert int(checks[0]["rejected"]) > 0


@pytest.fixture(scope="module")
def csky20():
    """The JAX package's csky3d(20) f32 setup with check_tentagg, its
    bench hierarchy's solve to 1e-6."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MGS_NO_WARMSET", "1")
        ja = j_csky3d(20).to_ell(dtype=jnp.float32, with_transpose=True)
        s = jagg.build_amg_setup(ja, HierarchyConfig(
            max_coarse_size=512, aggregation=AggregationConfig(
                **tcfg.CSKY_AGGREGATION, check_tentagg=True)))
        h = j_build(s.matrices[0], s.level_labels, s.matrices[1:],
                    **tcfg.BENCH_HIERARCHY)
        b = np.random.RandomState(0).rand(ja.nrows)
        res = j_solve(h, b, method="bicgstab", tol=1e-6, maxiter=200)
    return dict(ja=ja, setup=s, b=b, iterations=int(res.iterations))


def test_check_tentagg_setup_csky20(csky20):
    js = csky20["setup"]
    ts = tagg.build_amg_setup(to_port(csky20["ja"]), tcfg.HierarchyConfig(
        max_coarse_size=512, aggregation=tcfg.AggregationConfig(
            **tcfg.CSKY_AGGREGATION, check_tentagg=True)))
    assert [m.nrows for m in ts.matrices] == [m.nrows for m in js.matrices]
    for tl, jl in zip(ts.level_labels, js.level_labels):
        bits(tl, jl)
    for tm, jm in zip(ts.matrices[1:], js.matrices[1:]):
        bits(tm.vals, jm.vals)
    # every round's second pass was checked
    assert all(p.checks for r in ts.rounds for p in r.passes[1:])
    h = build_hierarchy(ts.matrices[0], ts.level_labels, ts.matrices[1:],
                        **tcfg.BENCH_HIERARCHY)
    res = solve_hierarchy(h, csky20["b"], method="bicgstab", tol=1e-6,
                          maxiter=200)
    assert res.status == 0 and res.iterations == csky20["iterations"]
