"""Every smoother kind on a sharded hierarchy in one process, held to the
JAX package's sharded run and to the port's unsharded one.

* ``two_level_from_p`` of the JAX package on poisson2d(16) in float64
  with pairs of nodes as aggregates (``tests/test_parallel.py``'s
  ``test_precondition_identical``), sharded by its ``shard_hierarchy``
  on the 8-device CPU mesh; the same hierarchy carried into the port
  (``interop.hierarchy_from_numpy``: the JAX operators, labels, smoothing
  diagonal and ILU factors) and sharded over ``RowMesh(8, "cpu")``: one
  preconditioner application of each kind (jacobi, l1jacobi, gs2, ilu0)
  to rtol 1e-11, atol 1e-13;
* poisson2d(64) through the port's setup and a K-cycle with the two
  finest levels sharded on 3 and on 4 shards (3 grows the padding): each
  kind's BiCGStab count equals the unsharded one, gs2's halves ride the
  halo and ilu0's L and U the index-list exchange, with the smoother's
  vectors padded to the level.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from multigridsolver_tpu.parallel import make_row_mesh as j_mesh
from multigridsolver_tpu.parallel import shard_hierarchy as j_shard_hier
from multigridsolver_tpu.setup.prolongation import p_csr_from_labels as \
    j_p_from_labels
from multigridsolver_tpu.solve import two_level_from_p as j_two_level
from multigridsolver_tpu.solve.api import pad_vector as j_pad
from multigridsolver_tpu.sparse.formats import CSR as JCSR
from multigridsolver_tpu_torch import interop
from multigridsolver_tpu_torch.cli import generators as tgen
from multigridsolver_tpu_torch.parallel import (ExchangeELL, HaloOp, RowMesh,
                                                shard_hierarchy)
from multigridsolver_tpu_torch.parallel.halo import spmv_route
from multigridsolver_tpu_torch.setup.aggregation import build_amg_setup
from multigridsolver_tpu_torch.solve.api import pad_vector, solve_hierarchy
from multigridsolver_tpu_torch.solve.hierarchy import build_hierarchy
from multigridsolver_tpu_torch.utils import config as tcfg

KINDS = ("jacobi", "l1jacobi", "gs2", "ilu0")
NDEV = 8
SMALL = 16
GRID = 64
KCYCLE = dict(cycle="kcycle", pre_smooth=1, post_smooth=1, kcycle_depth=3)


@pytest.fixture(scope="module", autouse=True)
def no_warmset():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MGS_NO_WARMSET", "1")
        yield


def ell_dict(e):
    return dict(cols=np.asarray(e.cols), vals=np.asarray(e.vals),
                rownnz=np.asarray(e.rownnz), nrows=e.nrows, ncols=e.ncols)


@pytest.fixture(scope="module")
def jax_two_level():
    """Per kind: the JAX package's sharded preconditioner output and what
    the port needs to rebuild the same hierarchy."""
    assert len(jax.devices()) >= NDEV, "conftest must fake 8 CPU devices"
    mesh = j_mesh(NDEV)
    a = tgen.poisson2d(SMALL).to_scipy()
    n = a.shape[0]
    labels = (np.arange(n) // 2).astype(np.int32)
    p = j_p_from_labels(labels, n // 2)
    ja = JCSR.from_scipy(a)
    fine = ell_dict(ja.to_ell(dtype=jnp.float64))
    v = np.random.RandomState(2).rand(n)
    out = {}
    for kind in KINDS:
        hier = j_two_level(ja, p, smoother_kind=kind, dtype=jnp.float64)
        hs = j_shard_hier(hier, mesh)
        vs = j_pad(v, hs.levels[0].a.npad, jnp.float64)
        lvl, sm = hier.levels[0], hier.levels[0].smoother
        state = dict(d=np.asarray(sm.d))
        if kind == "ilu0":
            state.update(lvals=np.asarray(sm.lmat.vals),
                         uvals=np.asarray(sm.umat.vals),
                         udiag=np.asarray(sm.udiag))
        out[kind] = dict(
            want=np.asarray(jax.jit(hs.precondition)(vs))[:n],
            mats=[fine, ell_dict(hier.coarse.a)],
            labels=np.asarray(lvl.labels), state=state, v=v,
            settings=dict(cycle=hier.cycle, pre_smooth=hier.pre_smooth,
                          post_smooth=hier.post_smooth))
    return out


@pytest.mark.parametrize("kind", KINDS)
def test_precondition_matches_jax_sharded(jax_two_level, kind):
    r = jax_two_level[kind]
    h = interop.hierarchy_from_numpy(
        r["mats"], [r["labels"]], smoother_state=[r["state"]],
        device="cpu", smoother_kind=kind, **r["settings"])
    hs = shard_hierarchy(h, RowMesh(NDEV, "cpu"))
    a = hs.levels[0].a
    assert isinstance(a, HaloOp) and a.npad % (NDEV * 8) == 0
    n = r["v"].shape[0]
    got = hs.precondition(pad_vector(r["v"], a.npad, torch.float64, "cpu"))
    np.testing.assert_allclose(got.numpy()[:n], r["want"], rtol=1e-11,
                               atol=1e-13)


@pytest.fixture(scope="module")
def grid_setup():
    ell = tgen.poisson2d(GRID).to_ell(dtype=torch.float64, device="cpu")
    cfg = tcfg.HierarchyConfig(max_coarse_size=512,
                               aggregation=tcfg.AggregationConfig(
                                   **tcfg.BENCH_AGGREGATION))
    return ell, build_amg_setup(ell, cfg)


@pytest.mark.parametrize("ndev", [3, 4])
@pytest.mark.parametrize("kind", KINDS)
def test_sharded_count_equals_unsharded(grid_setup, kind, ndev):
    ell, s = grid_setup
    h = build_hierarchy(s.matrices[0], s.level_labels, s.matrices[1:],
                        smoother_kind=kind, **KCYCLE)
    hs = shard_hierarchy(h, RowMesh(ndev, "cpu"), shard_levels=2)
    for lvl in hs.levels[:2]:
        sm, npad = lvl.smoother, lvl.a.npad
        assert sm.d.shape[0] == npad
        if kind == "gs2":
            assert [type(t) for t in (sm.lower, sm.upper)] == [HaloOp] * 2
            assert sm.lower.a.lanes.omax < 0 < sm.upper.a.lanes.omin
        if kind == "ilu0":
            assert [type(t) for t in (sm.lmat, sm.umat)] == [ExchangeELL] * 2
            assert [spmv_route(t) for t in (sm.lmat, sm.umat)] \
                == ["exchange"] * 2
            assert sm.udiag.shape[0] == npad
    assert (hs.levels[0].a.npad != h.levels[0].a.npad) == (ndev == 3)
    b = np.random.RandomState(0).rand(ell.nrows)
    r = solve_hierarchy(h, b, method="bicgstab", tol=1e-6, maxiter=200)
    rs = solve_hierarchy(hs, b, method="bicgstab", tol=1e-6, maxiter=200)
    assert rs.status == 0 and rs.relres < 1e-6
    assert rs.iterations == r.iterations
