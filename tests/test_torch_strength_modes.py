"""The port's strength and matching breadth against the JAX package's
plan-free path (CPU): Notay's μ (``mu_slots_notay``, the ``notay`` branch
of ``compute_strength``) bitwise against the jitted JAX form on
csky3d(10) (union field) and poisson2d(32) in f32 and f64, a notay
setup's levels and labels, and the skipass heuristic on the
diagonally dominated chain of ``tests/test_aggregation.py`` (fires at
0.7, not at 0.8) through ``mutual_match`` and ``pairwise_aggregate``."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import scipy.sparse as sp
import torch

from multigridsolver_tpu.cli.generators import csky3d as j_csky3d
from multigridsolver_tpu.cli.generators import poisson2d as j_poisson2d
from multigridsolver_tpu.setup import aggregation as jagg
from multigridsolver_tpu.setup.matching import mutual_match as j_match
from multigridsolver_tpu.setup.strength import compute_strength as j_strength
from multigridsolver_tpu.setup.strength import mu_slots_notay as j_notay
from multigridsolver_tpu.sparse.formats import CSR as JCSR
from multigridsolver_tpu.utils.config import (AggregationConfig,
                                              HierarchyConfig)
from multigridsolver_tpu_torch import interop
from multigridsolver_tpu_torch.setup import aggregation as tagg
from multigridsolver_tpu_torch.setup.matching import mutual_match
from multigridsolver_tpu_torch.setup.strength import (compute_strength,
                                                      mu_slots_notay)
from multigridsolver_tpu_torch.utils import config as tcfg

DTYPES = {"f32": jnp.float32, "f64": jnp.float64}
PROBLEMS = {
    "csky3d10": (lambda dt: j_csky3d(10).to_ell(dtype=dt,
                                                with_transpose=True),
                 tcfg.CSKY_AGGREGATION),
    "poisson2d32": (lambda dt: j_poisson2d(32).to_ell(dtype=dt),
                    tcfg.BENCH_AGGREGATION),
}
STRENGTH = dict(checkdd=-0.5, trspos=0.45, fracnegrcsum=0.25)
CASES = [(p, dt) for p in PROBLEMS for dt in DTYPES]

# the JAX pass evaluates strength inside one compiled program
j_strength_jit = jax.jit(j_strength, static_argnums=(1, 2, 3, 4, 5, 6),
                         static_argnames=("mu_mode", "mu_symmetrize"))
j_notay_jit = jax.jit(j_notay)
j_match_jit = jax.jit(j_match, static_argnames=("max_rounds",
                                                 "skipass_frac"))


def to_port(e):
    return interop.ell_from_numpy(
        np.asarray(e.cols), np.asarray(e.vals), np.asarray(e.rownnz),
        e.nrows, e.ncols, device="cpu",
        vals_t=None if e.vals_t is None else np.asarray(e.vals_t))


def bits(t, j):
    j = np.asarray(j)
    t = t.numpy()
    assert t.dtype == j.dtype and t.shape == j.shape
    np.testing.assert_array_equal(t.view(np.uint8), j.view(np.uint8))


def symmetric(problem):
    return PROBLEMS[problem][1].get("symmetric", False)


@pytest.fixture(scope="module")
def ref():
    """Per (problem, dtype): the JAX ELL, its first pass's coarse operator
    and a notay setup."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MGS_NO_WARMSET", "1")
        for p, dt in CASES:
            make, agg = PROBLEMS[p]
            a = make(DTYPES[dt])
            cfg = HierarchyConfig(max_coarse_size=512,
                                  aggregation=AggregationConfig(
                                      **agg, mu_mode="notay"))
            out[p, dt] = dict(a=a, setup=jagg.build_amg_setup(a, cfg))
    return out


@pytest.mark.parametrize("first", [True, False])
@pytest.mark.parametrize("problem,dt", CASES)
def test_mu_slots_notay_bitwise(ref, problem, dt, first):
    """(valp, ok) on the finest level (first pass: G0 and the zerors rule
    apply) and on the notay setup's first coarse level."""
    a = ref[problem, dt]["a"] if first else ref[problem, dt]["setup"] \
        .matrices[1]
    sym = symmetric(problem)
    ts = compute_strength(to_port(a), 10.0, first, symmetric=sym,
                          mu_mode="notay", **STRENGTH)
    valp, ok = mu_slots_notay(to_port(a), ts.diag, ts.si, ts.vals_t,
                              ts.zerors)
    jv, jok = j_notay_jit(a, jnp.asarray(ts.diag.numpy()),
                          jnp.asarray(ts.si.numpy()),
                          jnp.asarray(ts.vals_t.numpy()),
                          jnp.asarray(bool(ts.zerors)))
    valid = np.asarray(a.slot_mask())
    bits(valp[torch.from_numpy(valid)], np.asarray(jv)[valid])
    bits(ok, jok)
    # the whole strength evaluation, traced as the JAX pass traces it
    js = j_strength_jit(a, 10.0, first, -0.5, 0.45, 0.25, sym,
                        mu_mode="notay")
    bits(ts.allowed, js.allowed)
    bits(ts.excluded, js.excluded)
    bits(ts.mu[torch.from_numpy(valid)], np.asarray(js.mu)[valid])
    assert int(ts.allowed.sum()) > 0


@pytest.mark.parametrize("problem,dt", CASES)
def test_notay_setup_levels_and_labels(ref, problem, dt):
    js = ref[problem, dt]["setup"]
    agg = tcfg.AggregationConfig(**PROBLEMS[problem][1], mu_mode="notay")
    ts = tagg.build_amg_setup(to_port(ref[problem, dt]["a"]),
                              tcfg.HierarchyConfig(max_coarse_size=512,
                                                   aggregation=agg))
    assert [m.nrows for m in ts.matrices] == [m.nrows for m in js.matrices]
    for tl, jl in zip(ts.level_labels, js.level_labels):
        bits(tl, jl)
    for tm, jm in zip(ts.matrices[1:], js.matrices[1:]):
        bits(tm.vals, jm.vals)


def skipass_chain(n=64):
    """``tests/test_aggregation.py``'s periodic chain: ¾ of the rows
    hugely diagonally dominant (excluded), the rest a chain that pairs."""
    d = np.full(n, 2.05)
    d[: 3 * n // 4] = 1000.0
    a = sp.diags([d, -np.ones(n - 1), -np.ones(n - 1)], [0, -1, 1]).tolil()
    a[0, n - 1] = -1.0
    a[n - 1, 0] = -1.0
    return JCSR.from_scipy(sp.csr_matrix(a)).to_ell(dtype=jnp.float64)


@pytest.mark.parametrize("frac,fires", [(0.7, True), (0.8, False)])
def test_skipass_mutual_match(frac, fires):
    n = 64
    a = skipass_chain(n)
    ta = to_port(a)
    ts = compute_strength(ta, 10.0, True)
    js = j_strength_jit(a, 10.0, True, -0.5, 0.0, 0.0, False)
    bits(ts.excluded, js.excluded)
    paired = mutual_match(ta, ts, skipass_frac=frac)
    bits(paired, j_match_jit(a, js, skipass_frac=frac))
    excl = ts.excluded.numpy()[:n]
    nodes = np.arange(n)
    single = paired.numpy()[:n][~excl] == nodes[~excl]
    assert single.all() == fires


@pytest.mark.parametrize("npass", [1, 2])
def test_skipass_pairwise_aggregate(npass):
    """The first pass pairs nothing and one extra pass compensates: the
    pass sizes and labels equal the JAX package's."""
    a = skipass_chain(64)
    kw = dict(ktg=10.0, npass=npass, tou=1e9, skipass_frac=0.7)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MGS_NO_WARMSET", "1")
        jr = jagg.pairwise_aggregate(a, AggregationConfig(**kw))
    tr = tagg.pairwise_aggregate(to_port(a), tcfg.AggregationConfig(**kw))
    assert [p.nc for p in tr.passes] == [p.nc for p in jr.passes]
    assert len(tr.passes) == npass + 1
    assert tr.passes[0].nc == 16        # the 16 chain rows, as singletons
    bits(tr.labels, jr.labels)
