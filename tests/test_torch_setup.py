"""The port's aggregation setup against the JAX package's plan-free path
(CPU): strength, handshake matching, labelling, pairwise Galerkin and the
multilevel setup, bitwise on poisson2d(64) in f32 and f64."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from multigridsolver_tpu.cli.generators import poisson2d
from multigridsolver_tpu.setup import aggregation as jagg
from multigridsolver_tpu.setup import prolongation as jprol
from multigridsolver_tpu.setup.galerkin import galerkin_pair_ell as j_galerkin
from multigridsolver_tpu.setup.matching import _edge_hash as j_edge_hash
from multigridsolver_tpu.setup.strength import compute_strength as j_strength
from multigridsolver_tpu.utils.config import (AggregationConfig,
                                              HierarchyConfig)
from multigridsolver_tpu_torch.interop import ell_from_numpy
from multigridsolver_tpu_torch.setup import aggregation as tagg
from multigridsolver_tpu_torch.setup import prolongation as tprol
from multigridsolver_tpu_torch.setup.galerkin import galerkin_pair_ell
from multigridsolver_tpu_torch.setup.matching import (_edge_hash,
                                                      labels_from_pairs,
                                                      mutual_match)
from multigridsolver_tpu_torch.setup.strength import compute_strength
from multigridsolver_tpu_torch.utils import config as tcfg

N_GRID = 64
AGG = tcfg.BENCH_AGGREGATION
STRENGTH = dict(checkdd=-0.5, trspos=0.45, fracnegrcsum=0.25,
                symmetric=True)
DTYPES = {"f32": jnp.float32, "f64": jnp.float64}

# the JAX pass runs strength inside one jitted program; compile it the
# same way so the reference μ is the compiled one
j_strength_jit = jax.jit(j_strength, static_argnums=(1, 2, 3, 4, 5, 6))


def to_port(e):
    return ell_from_numpy(np.asarray(e.cols), np.asarray(e.vals),
                          np.asarray(e.rownnz), e.nrows, e.ncols,
                          device="cpu")


def j_match(a, first):
    paired, labels, packed, _, _ = jagg._match_pass(
        a, first, 10.0, -0.5, 0.45, 0.25, 64, True, "simple", 0.0)
    return np.array(paired), np.array(labels), int(packed[0])


@pytest.fixture(scope="module")
def ref():
    """One JAX reference run per dtype: the whole setup, and the two
    passes of the first round with their operators."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MGS_NO_WARMSET", "1")
        cfg = HierarchyConfig(max_coarse_size=512,
                              aggregation=AggregationConfig(**AGG))
        for dt, jdt in DTYPES.items():
            a = poisson2d(N_GRID).to_ell(dtype=jdt)
            paired1, labels1, nc1 = j_match(a, True)
            c1, _ = j_galerkin(a, jnp.asarray(paired1), jnp.asarray(labels1),
                               nc1)
            paired2, labels2, nc2 = j_match(c1, False)
            out[dt] = dict(
                setup=jagg.build_amg_setup(a, cfg),
                passes=[(a, True, paired1, labels1, nc1),
                        (c1, False, paired2, labels2, nc2)])
    return out


@pytest.mark.parametrize("level", [0, 1])
def test_edge_hash_bitwise(ref, level):
    a = ref["f64"]["passes"][level][0]
    np.testing.assert_array_equal(_edge_hash(to_port(a)).numpy(),
                                  np.asarray(j_edge_hash(a)))


@pytest.mark.parametrize("pass_no", [0, 1])
@pytest.mark.parametrize("dt", list(DTYPES))
def test_strength_bitwise(ref, dt, pass_no):
    a, first, *_ = ref[dt]["passes"][pass_no]
    js = j_strength_jit(a, 10.0, first, -0.5, 0.45, 0.25, True)
    ts = compute_strength(to_port(a), 10.0, first, **STRENGTH)
    valid = np.asarray(a.slot_mask())
    np.testing.assert_array_equal(ts.diag.numpy(), np.asarray(js.diag))
    np.testing.assert_array_equal(ts.si.numpy(), np.asarray(js.si))
    np.testing.assert_array_equal(ts.excluded.numpy(),
                                  np.asarray(js.excluded))
    np.testing.assert_array_equal(ts.mu.numpy()[valid],
                                  np.asarray(js.mu)[valid])
    np.testing.assert_array_equal(ts.allowed.numpy(), np.asarray(js.allowed))
    assert bool(ts.zerors) == bool(js.zerors)


@pytest.mark.parametrize("pass_no", [0, 1])
@pytest.mark.parametrize("dt", list(DTYPES))
def test_match_pass_bitwise(ref, dt, pass_no):
    a, first, paired, labels, nc = ref[dt]["passes"][pass_no]
    ta = to_port(a)
    st = compute_strength(ta, 10.0, first, **STRENGTH)
    t_paired = mutual_match(ta, st)
    np.testing.assert_array_equal(t_paired.numpy(), paired)
    t_labels, t_nc = labels_from_pairs(t_paired, st.excluded, ta)
    assert t_labels.dtype == torch.int32
    np.testing.assert_array_equal(t_labels.numpy(), labels)
    assert t_nc == nc


@pytest.mark.parametrize("dt", list(DTYPES))
def test_galerkin_pair_ell(ref, dt):
    a, _, paired, labels, nc = ref[dt]["passes"][0]
    j_ell, j_nnz = j_galerkin(a, jnp.asarray(paired), jnp.asarray(labels), nc)
    t_ell, t_nnz = galerkin_pair_ell(to_port(a), torch.from_numpy(paired),
                                     torch.from_numpy(labels), nc)
    assert t_nnz == j_nnz
    assert (t_ell.nrows, t_ell.ncols, t_ell.k) == (j_ell.nrows, j_ell.ncols,
                                                   j_ell.k)
    np.testing.assert_array_equal(t_ell.cols.numpy(), np.asarray(j_ell.cols))
    np.testing.assert_array_equal(t_ell.rownnz.numpy(),
                                  np.asarray(j_ell.rownnz))
    rtol = 1e-6 if dt == "f32" else 1e-12
    np.testing.assert_allclose(t_ell.vals.numpy(), np.asarray(j_ell.vals),
                               rtol=rtol, atol=0)


def test_galerkin_of_float_values_matches_dense_product():
    """Non-integer values: the pairwise merge equals Pᵀ A P."""
    a = poisson2d(24)
    rs = np.random.RandomState(3)
    a.data = a.data * (1.0 + 0.1 * rs.rand(a.nnz))
    ta = to_port(a.to_ell(dtype=jnp.float64))
    n = a.nrows
    paired = np.arange(ta.npad, dtype=np.int32)
    paired[:n - 1:2] += 1
    paired[1:n:2] -= 1
    paired[n:] = -1
    labels = np.where(np.arange(ta.npad) < n, np.arange(ta.npad) // 2, -1)
    nc = (n + 1) // 2
    c, _ = galerkin_pair_ell(ta, torch.from_numpy(paired),
                             torch.from_numpy(labels.astype(np.int32)), nc)
    p = tprol.p_csr_from_labels(labels[:n], nc).to_dense()
    np.testing.assert_allclose(c.to_csr().to_dense(), p.T @ a.to_dense() @ p,
                               rtol=1e-13, atol=1e-13)


@pytest.mark.parametrize("dt", list(DTYPES))
def test_build_amg_setup_levels_and_labels(ref, dt):
    js = ref[dt]["setup"]
    cfg = tcfg.HierarchyConfig(max_coarse_size=512,
                               aggregation=tcfg.AggregationConfig(**AGG))
    tdt = torch.float32 if dt == "f32" else torch.float64
    from multigridsolver_tpu_torch.cli.generators import poisson2d as tp2d
    ts = tagg.build_amg_setup(tp2d(N_GRID).to_ell(dtype=tdt, device="cpu"),
                              cfg)
    assert [m.nrows for m in ts.matrices] == [m.nrows for m in js.matrices]
    assert len(ts.level_labels) == len(js.level_labels) >= 2
    for tl, jl in zip(ts.level_labels, js.level_labels):
        np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    for tm, jm in zip(ts.matrices, js.matrices):
        np.testing.assert_array_equal(tm.cols.numpy(), np.asarray(jm.cols))
        np.testing.assert_array_equal(tm.vals.numpy(), np.asarray(jm.vals))
        np.testing.assert_array_equal(tm.rownnz.numpy(),
                                      np.asarray(jm.rownnz))


def test_unported_options_raise():
    """Every option is ported: the greedy matching runs (in the C++ host
    runtime) and gives the JAX package's labels, an unknown matching is
    refused, and the quality options run (held to the JAX package in
    ``test_torch_tentagg.py`` and ``test_torch_strength_modes.py``)."""
    jell = poisson2d(8).to_ell(dtype=jnp.float64)
    ell = to_port(jell)
    greedy = {**AGG, "matching": "greedy"}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MGS_NO_WARMSET", "1")
        want = jagg.pairwise_aggregate(jell, AggregationConfig(**greedy))
    got = tagg.pairwise_aggregate(ell, tcfg.AggregationConfig(**greedy))
    np.testing.assert_array_equal(got.labels.numpy(),
                                  np.asarray(want.labels))
    assert got.nc == want.nc > 0
    with pytest.raises(ValueError, match="unknown matching"):
        tagg.pairwise_aggregate(
            ell, tcfg.AggregationConfig(**{**AGG, "matching": "random"}))
    for ok in (dict(check_tentagg=True), dict(skipass_frac=0.5),
               dict(mu_mode="notay")):
        assert tagg.pairwise_aggregate(
            ell, tcfg.AggregationConfig(**{**AGG, **ok})).nc > 0


def test_label_transfers_match_jax():
    rs = np.random.RandomState(5)
    labels = rs.randint(-1, 300, 2048).astype(np.int32)
    coarser = rs.randint(-1, 90, 300).astype(np.int32)
    np.testing.assert_array_equal(
        tprol.compose_labels(torch.from_numpy(labels),
                             torch.from_numpy(coarser)).numpy(),
        np.asarray(jprol.compose_labels(jnp.asarray(labels),
                                        jnp.asarray(coarser))))
    xc = rs.rand(1024)
    np.testing.assert_array_equal(
        tprol.prolong(torch.from_numpy(labels), torch.from_numpy(xc)).numpy(),
        np.asarray(jprol.prolong(jnp.asarray(labels), jnp.asarray(xc))))
    v = rs.rand(2048)
    np.testing.assert_allclose(
        tprol.restrict(torch.from_numpy(labels), torch.from_numpy(v),
                       1024).numpy(),
        np.asarray(jprol.restrict(jnp.asarray(labels), jnp.asarray(v), 1024)),
        rtol=1e-12)


def test_p_csr_roundtrip():
    labels = np.array([0, 0, 1, -1, 2, 1], np.int32)
    p = tprol.p_csr_from_labels(labels, 3)
    back, nc = tprol.labels_from_p_csr(p)
    np.testing.assert_array_equal(back, labels)
    assert nc == 3
