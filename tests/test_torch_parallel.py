"""The port's row-sharded path (``multigridsolver_tpu_torch/parallel``)
against the JAX package's, on the CPU.

The JAX side runs on the conftest's virtual CPU mesh (``make_row_mesh(4)``);
the port's on a ``RowMesh(4, "cpu")``, whose four shards share the CPU.
K4's reference is the JAX package's ``windowed_take_sharded`` run through
the Pallas interpreter, as ``tests/test_parallel.py`` runs it.  Inputs are
made from numpy seeds.  Gathers and labels are compared bitwise; SpMVs in
float64 to 1e-12 relative, since the halo operator adds the boundary
corrections after the interior and so sums boundary rows in another order
than a single-device SpMV.
"""
import ast
import os
from unittest import mock

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import scipy.sparse as sp
import torch

from multigridsolver_tpu.cli import generators as jgen
from multigridsolver_tpu.ops import gather_pallas as gp
from multigridsolver_tpu.parallel import (build_amg_setup_sharded as
                                          j_setup_sharded)
from multigridsolver_tpu.parallel import make_row_mesh as j_mesh
from multigridsolver_tpu.parallel import shard_hierarchy as j_shard_hier
from multigridsolver_tpu.parallel import shard_operator as j_shard_op
from multigridsolver_tpu.parallel import shard_ell as j_shard_ell
from multigridsolver_tpu.parallel import shard_vector as j_shard_vector
from multigridsolver_tpu.parallel.dist_setup import shard_ell_planned
from multigridsolver_tpu.parallel.exchange import (
    build_exchange_plan as j_plan, exchange_ell as j_exchange_ell)
from multigridsolver_tpu.parallel.halo import make_halo_spmv as j_halo_spmv
from multigridsolver_tpu.setup.aggregation import build_amg_setup as j_setup
from multigridsolver_tpu.solve.api import pad_vector as j_pad
from multigridsolver_tpu.solve.api import solve_hierarchy as j_solve
from multigridsolver_tpu.solve.hierarchy import build_hierarchy as j_build
from multigridsolver_tpu.sparse import hybrid as jhyb
from multigridsolver_tpu.sparse import ops as jops
from multigridsolver_tpu.sparse.formats import CSR as JCSR
from multigridsolver_tpu.utils.config import (AggregationConfig,
                                              HierarchyConfig)
from multigridsolver_tpu_torch import interop
from multigridsolver_tpu_torch.cli import generators as tgen
from multigridsolver_tpu_torch.ops import gather as g
from multigridsolver_tpu_torch.parallel import (HaloOp, RowMesh,
                                                build_amg_setup_sharded,
                                                build_exchange_plan,
                                                exchange_ell, halo_width,
                                                shard_ell,
                                                shard_ell_halo,
                                                shard_hierarchy,
                                                shard_operator)
from multigridsolver_tpu_torch.parallel.exchange import exchange_recv
from multigridsolver_tpu_torch.parallel.halo import make_halo_op, spmv_route
from multigridsolver_tpu_torch.setup.aggregation import build_amg_setup
from multigridsolver_tpu_torch.solve.api import pad_vector, solve_hierarchy
from multigridsolver_tpu_torch.solve.hierarchy import build_hierarchy
from multigridsolver_tpu_torch.sparse import hybrid as thyb
from multigridsolver_tpu_torch.sparse import ops as tops
from multigridsolver_tpu_torch.sparse.formats import CSR as TCSR
from multigridsolver_tpu_torch.utils import config as tcfg

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NDEV = 4
AGG = dict(npass=2, symmetric=True)
PALLAS_FNS = (gp.windowed_gather_spmv, gp.windowed_take,
              gp.windowed_take_rows)


def to_port(e):
    return interop.ell_from_numpy(np.asarray(e.cols), np.asarray(e.vals),
                                  np.asarray(e.rownnz), e.nrows, e.ncols,
                                  device="cpu")


def ell_dict(e):
    return dict(cols=np.asarray(e.cols), vals=np.asarray(e.vals),
                rownnz=np.asarray(e.rownnz), nrows=e.nrows, ncols=e.ncols)


def local_noise(n, rs, nnz=120, spread=150):
    """Sparse noise whose columns stay near the diagonal (the remainder
    shape the index-list plan accepts; ``tests/test_parallel.py``)."""
    r = rs.randint(0, n, size=nnz)
    c = np.clip(r + rs.randint(-spread, spread + 1, size=nnz), 0, n - 1)
    return sp.coo_matrix((rs.randn(nnz), (r, c)), shape=(n, n)).tocsr()


def k4_calls():
    """Count the sharded gathers that take K4's wrapper."""
    return mock.patch.object(g, "take_sharded", wraps=g.take_sharded)


def sharded_spmv_calls():
    """Count the sharded SpMVs that take ``hyb_spmv_sharded``'s wrapper."""
    return mock.patch.object(g, "hyb_spmv_sharded",
                             wraps=g.hyb_spmv_sharded)


def halo_case(case, jmesh, mesh):
    """A sharded hybrid operator of each remainder route, the JAX
    package's and the port's, with a random x (numpy seed)."""
    rs = np.random.RandomState(5)
    if case == "dia":
        m = jgen.poisson2d(40).to_scipy()
    elif case == "exchange":
        m = (jgen.poisson2d(30).to_scipy() + local_noise(900, rs)).tocsr()
    else:   # uniform noise: the plan is refused
        m = (jgen.poisson2d(30).to_scipy()
             + sp.random(900, 900, density=0.01, random_state=rs,
                         format="csr")).tocsr()
    je = JCSR.from_scipy(m).to_ell(dtype=jnp.float64)
    jh = j_shard_op(jhyb.hybrid_from_ell_device(je), jmesh)
    op = make_halo_op(shard_operator(thyb.hybrid_from_ell(to_port(je)),
                                     mesh), mesh)
    x = np.zeros(op.npad)
    x[: m.shape[1]] = rs.randn(m.shape[1])
    return m, jh, op, x


@pytest.fixture(scope="module")
def jmesh():
    assert len(jax.devices()) >= NDEV, "conftest must fake CPU devices"
    return j_mesh(NDEV)


@pytest.fixture(scope="module")
def mesh():
    return RowMesh(NDEV, "cpu")


@pytest.fixture(scope="module")
def interp_ref(jmesh):
    """The JAX package's K4 path under the Pallas interpreter, once: the
    planned sharded poisson2d(64) f32 ELL, its neighbour gathers of an f32
    and a bool field and of a custom 1-D index, and its whole sharded
    setup."""
    rs = np.random.RandomState(3)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MGS_NO_WARMSET", "1")
        mp.setattr(gp, "INTERPRET", True)
        for fn in PALLAS_FNS:
            fn.clear_cache()
        try:
            ell = jgen.poisson2d(64).to_ell(dtype=jnp.float32)
            sh = shard_ell_planned(ell, jmesh)
            assert sh is not None and sh.shard is not None
            xf = rs.rand(sh.npad).astype(np.float32)
            xb = rs.rand(sh.npad) < 0.5
            take = jax.jit(jops.take_neighbor)
            custom = jax.jit(lambda a, v, i: jops.take_neighbor(a, v, idx=i))
            idx = np.arange(sh.npad, dtype=np.int32)
            cfg = HierarchyConfig(max_coarse_size=64,
                                  aggregation=AggregationConfig(**AGG))
            setup = j_setup_sharded(ell, cfg, jmesh)
            assert setup.matrices[0].shard is not None
            return dict(
                ell=ell, xf=xf, xb=xb, idx=idx,
                out_f=np.asarray(take(sh, jnp.asarray(xf))),
                out_b=np.asarray(take(sh, jnp.asarray(xb))),
                out_i=np.asarray(custom(sh, jnp.asarray(xf),
                                        jnp.asarray(idx))),
                levels=[m.nrows for m in setup.matrices],
                labels=[np.asarray(l) for l in setup.level_labels])
        finally:
            for fn in PALLAS_FNS:
                fn.clear_cache()


@pytest.fixture(scope="module")
def port_sharded64(interp_ref, mesh):
    return shard_ell_halo(to_port(interp_ref["ell"]), mesh)


class TestRowMesh:
    def test_collectives(self, mesh):
        send = torch.arange(NDEV * 3, dtype=torch.float64).view(NDEV, 3) + 1
        opened = mesh.shift_open(send, 1)
        assert torch.equal(opened[0], torch.zeros(3, dtype=torch.float64))
        assert torch.equal(opened[1:], send[:-1])
        assert torch.equal(mesh.shift_open(send, -1)[-1],
                           torch.zeros(3, dtype=torch.float64))
        ring = mesh.shift_ring(send, 1)
        assert torch.equal(ring[0], send[-1]) and torch.equal(ring[1:],
                                                              send[:-1])
        blocks = torch.arange(NDEV * NDEV * 2).view(NDEV, NDEV, 2)
        recv = mesh.all_to_all(blocks)
        for s in range(NDEV):
            for t in range(NDEV):
                assert torch.equal(recv[t, s], blocks[s, t])
        assert torch.equal(mesh.all_gather(send), send.reshape(-1))
        halo = mesh.boundary_halo(send.reshape(-1), 2)
        assert halo.shape == (NDEV, 2, 2)
        assert not halo[0, 0].any() and not halo[-1, 1].any()
        assert torch.equal(halo[1, 0], send[0, 1:])
        assert torch.equal(halo[0, 1], send[1, :2])

    @pytest.mark.parametrize("dtype", [torch.bool, torch.uint8,
                                       torch.float32, torch.int32,
                                       torch.float64, torch.int64])
    @pytest.mark.parametrize("ndev,npr,h", [(NDEV, 6, 2), (3, 5, 5),
                                            (1, 4, 3), (NDEV, 4, 0)])
    def test_halo_fill_is_the_two_open_shifts(self, dtype, ndev, npr, h):
        """The halo K4 and the sharded SpMV read: ``[s, 0]`` the last h
        words of shard s - 1 and ``[s, 1]`` the first h of shard s + 1, as
        the two non-cyclic shifts give them, with zeros at the mesh ends;
        one dtype in, the same out."""
        mesh = RowMesh(ndev, "cpu")
        rs = np.random.RandomState(ndev * 100 + npr * 10 + h)
        x = torch.from_numpy(rs.randint(1, 100, ndev * npr)).to(dtype)
        xs = x.view(ndev, npr)
        halo = mesh.boundary_halo(x, h)
        assert halo.shape == (ndev, 2, h) and halo.dtype == dtype
        assert torch.equal(halo, g.halo_fill_plain(x, ndev, h))
        assert torch.equal(halo, torch.stack(
            [mesh.shift_open(xs[:, npr - h:], 1),
             mesh.shift_open(xs[:, :h], -1)], 1))
        assert not halo[0, 0].any() and not halo[-1, 1].any()
        for s in range(1, ndev):
            assert torch.equal(halo[s, 0], xs[s - 1, npr - h:])
            assert torch.equal(halo[s - 1, 1], xs[s, :h])

    def test_several_devices_not_ported(self):
        with pytest.raises(NotImplementedError):
            RowMesh(2, ["cpu", "meta"])
        assert RowMesh(2, ["cpu", "cpu"]).device == torch.device("cpu")


class TestK4:
    @pytest.mark.parametrize("field", ["f32", "bool"])
    def test_take_neighbor_matches_jax_kernel(self, interp_ref,
                                              port_sharded64, field):
        """K4's plain version through ``take_neighbor`` against the JAX
        package's ``windowed_take_sharded`` under the interpreter, bitwise
        on the valid slots.  The two pad differently (the port to a
        multiple of 4·1024 rows, JAX to its window size), so the logical
        rows are compared."""
        r, a = interp_ref, port_sharded64
        assert a.shard is not None and a.shard[1:] == (1024, 128)
        x = r["xf"] if field == "f32" else r["xb"]
        with k4_calls() as calls:
            out = tops.take_neighbor(a, torch.from_numpy(x[: a.npad])).numpy()
        # one K4 call on the field as it is: a bool field as its bytes,
        # with no int32 round trip
        assert calls.call_count == 1
        assert calls.call_args.args[1].dtype == torch.from_numpy(x).dtype
        ref = r["out_f"] if field == "f32" else r["out_b"]
        n = a.nrows
        valid = a.slot_mask().numpy()[:, :n]
        assert out.dtype == ref.dtype
        np.testing.assert_array_equal(out[:, :n][valid], ref[:, :n][valid])

    def test_custom_index_matches_jax_kernel(self, interp_ref,
                                             port_sharded64):
        """A 1-D index over the own rows (the proposal-of-proposal
        gather) is served in full."""
        r, a = interp_ref, port_sharded64
        idx = torch.from_numpy(r["idx"][: a.npad])
        out = tops.take_neighbor(a, torch.from_numpy(r["xf"][: a.npad]),
                                 idx=idx).numpy()
        np.testing.assert_array_equal(out, r["out_i"][: a.npad])
        np.testing.assert_array_equal(out, r["xf"][: a.npad])

    @pytest.mark.parametrize("dtype", [np.float32, np.int32, np.float64,
                                       np.int64, np.uint8, np.bool_])
    def test_wrapper_equals_global_gather_in_range(self, dtype):
        """Indices inside each shard's covered range read the global
        source; -1 sentinels and other out-of-range indices clamp into the
        range, in the wrapper as in its plain version."""
        rs = np.random.RandomState(5)
        npr, h, ndev, k = 512, 128, NDEV, 3
        n = npr * ndev
        rows = np.arange(n)
        idx = np.clip(rows + rs.randint(-h, h + 1, (k, n)), 0, n - 1)
        x = torch.from_numpy((rs.rand(n) * 1e6).astype(dtype)
                             if dtype != np.bool_ else rs.rand(n) < 0.5)
        halo = RowMesh(ndev, "cpu").boundary_halo(x, h)
        out = g.take_sharded(torch.from_numpy(idx.astype(np.int32)), x, halo,
                             npr, h)
        np.testing.assert_array_equal(out.numpy(), x.numpy()[idx])
        bad = idx[0].copy()
        bad[rs.rand(n) < 0.2] = -1
        bad_t = torch.from_numpy(bad.astype(np.int32))
        assert torch.equal(g.take_sharded(bad_t, x, halo, npr, h),
                           g.take_sharded_plain(bad_t, x, halo, npr, h))
        ok = bad >= 0
        np.testing.assert_array_equal(
            g.take_sharded(bad_t, x, halo, npr, h).numpy()[ok],
            x.numpy()[bad[ok]])

    def test_wrapper_rejects_what_kernel_does_not_take(self):
        x = torch.zeros(8)
        halo = torch.zeros(2, 2, 2)
        with pytest.raises(ValueError):        # idx not int32
            g.take_sharded(torch.zeros(8, dtype=torch.int64), x, halo, 4, 2)
        with pytest.raises(ValueError):        # halo wider than a shard
            g.take_sharded(torch.zeros(8, dtype=torch.int32), x,
                           torch.zeros(2, 2, 5), 4, 5)
        with pytest.raises(ValueError):        # x not ndev * npr long
            g.take_sharded(torch.zeros(8, dtype=torch.int32),
                           torch.zeros(9), halo, 4, 2)


class TestExchange:
    def test_plan_bitwise_against_jax(self):
        rs = np.random.RandomState(11)
        m = (jgen.poisson2d(64).to_scipy()
             + local_noise(4096, rs, nnz=800, spread=100)).tocsr()
        e = TCSR.from_scipy(m).to_ell(dtype=torch.float64, device="cpu")
        cols, rownnz = e.cols.numpy(), e.rownnz.numpy()
        jp, tp = j_plan(cols, rownnz, NDEV), build_exchange_plan(cols, rownnz,
                                                                 NDEV)
        assert jp is not None and tp is not None and tp.L > 0
        assert (tp.L, tp.ndev, tp.n_local) == (jp.L, jp.ndev, jp.n_local)
        np.testing.assert_array_equal(tp.send_idx, jp.send_idx)
        np.testing.assert_array_equal(tp.cols, jp.cols)
        dense = np.random.RandomState(3).randint(0, 128, (16, 128))
        full = np.full((128,), 16, np.int32)
        assert j_plan(dense, full, NDEV) is None
        assert build_exchange_plan(dense, full, NDEV) is None

    def test_exchange_ell_irregular_operator(self, jmesh, mesh):
        """Coarse-level-like irregular ELL (stencil plus scattered local
        fill): the index-list exchange gives the JAX package's sharded
        SpMV and the single-device one, with K1 on every shard."""
        rs = np.random.RandomState(11)
        m = (jgen.poisson2d(64).to_scipy()
             + local_noise(4096, rs, nnz=800, spread=100)).tocsr()
        je = JCSR.from_scipy(m).to_ell(dtype=jnp.float64)
        jop = j_exchange_ell(j_shard_ell(je, jmesh), jmesh)
        op = exchange_ell(shard_ell(to_port(je), mesh), mesh)
        assert op is not None and jop is not None and op.L == jop.L > 0
        x = np.zeros(op.npad)
        x[: m.shape[1]] = rs.randn(m.shape[1])
        with sharded_spmv_calls() as k1:
            y = tops.spmv(op, torch.from_numpy(x)).numpy()
        # one sharded SpMV for all shards, reading [x_local | recv] in place
        assert k1.call_count == 1
        assert k1.call_args.kwargs["route"] == "exchange"
        assert k1.call_args.kwargs["recv"].shape == (NDEV, NDEV * op.L)
        y_j = np.asarray(jax.jit(jops.spmv)(
            jop, j_shard_vector(jnp.asarray(x), jmesh)))
        np.testing.assert_allclose(y, y_j, rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(y[: m.shape[0]], m @ x[: m.shape[1]],
                                   rtol=1e-12, atol=1e-12)


class TestHaloSpMV:
    @pytest.mark.parametrize("case", ["dia", "exchange", "all_gather"])
    def test_matches_jax_and_scipy(self, jmesh, mesh, case):
        """``HaloOp.spmv`` is one ``hyb_spmv_sharded`` call (its plain
        version here) and gives the JAX package's sharded SpMV and
        scipy's."""
        m, jh, op, x = halo_case(case, jmesh, mesh)
        assert isinstance(op, HaloOp) and op.route == {
            "dia": "none", "exchange": "exchange",
            "all_gather": "all_gather"}[case]
        assert op.npad == jh.npad and op.offsets == jh.offsets
        with sharded_spmv_calls() as calls:
            y = tops.spmv(op, torch.from_numpy(x)).numpy()
        assert calls.call_count == 1
        assert calls.call_args.kwargs["route"] == op.route
        y_j = np.asarray(jax.jit(j_halo_spmv(jh, jmesh))(
            j_shard_vector(jnp.asarray(x), jmesh)))
        np.testing.assert_allclose(y, y_j, rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(y[: m.shape[0]], m @ x[: m.shape[1]],
                                   rtol=1e-12, atol=1e-12)

    @pytest.mark.parametrize("case", ["dia", "exchange", "all_gather"])
    def test_open_halo_equals_ring_halo_bitwise(self, jmesh, mesh, case):
        """The sharded SpMV reads the non-cyclic halo (zeros at the mesh
        ends); the ring exchange it replaced, as the JAX package runs it,
        carries the far end's values there.  Those only meet zero dval
        lanes, so the two give the same bits, for an x that is nonzero at
        both ends."""
        _, _, op, x = halo_case(case, jmesh, mesh)
        x = torch.from_numpy(x + 1.0)
        ndev, w = mesh.ndev, halo_width(op.a)
        xs = x.view(ndev, -1)
        ring = torch.stack([mesh.shift_ring(xs[:, xs.shape[1] - w:], 1),
                            mesh.shift_ring(xs[:, :w], -1)], 1)
        assert not torch.equal(ring, mesh.boundary_halo(x, w))
        recv = exchange_recv(xs, op.ex_send_idx, mesh) if op.ex_L else None
        args = (op.a.dvals, op.a.lanes, x, ndev)
        rest = dict(cols=op.rest_cols, vals=op.rest_vals, recv=recv,
                    route=op.route)
        y_ring = g.hyb_spmv_sharded_plain(*args, halo=ring, **rest)
        assert torch.equal(tops.spmv(op, x), y_ring)

    @pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
    def test_two_levels_fold_order_of_the_lane_loop(self, mesh, dtype):
        """On both sharded levels of poisson2d(64) (pure DIA, then 48
        lanes with an exchanged remainder) the sharded SpMV is bitwise
        the route it replaced: the interior lane loop, the remainder by
        K1 on each shard on ``[x_local | recv]``, then the corrections."""
        ell = tgen.poisson2d(64).to_ell(dtype=dtype, device="cpu")
        cfg = tcfg.HierarchyConfig(max_coarse_size=512,
                                   aggregation=tcfg.AggregationConfig(
                                       ktg=10.0, npass=2, tou=8.0,
                                       symmetric=True))
        s = build_amg_setup(ell, cfg)
        rs = np.random.RandomState(2)
        for lvl in range(2):
            op = make_halo_op(shard_operator(
                thyb.hybrid_from_ell(s.matrices[lvl]), mesh), mesh)
            assert op.route == ("none", "exchange")[lvl]
            x = torch.from_numpy(rs.rand(op.npad)).to(dtype)
            ndev, w = mesh.ndev, halo_width(op.a)
            xs = x.view(ndev, -1)
            npr = xs.shape[1]
            dv = op.a.dvals.view(len(op.offsets), ndev, npr)
            y = g.sharded_dia_interior_plain(dv, xs, op.offsets, w)
            if op.route == "exchange":
                src = torch.cat([xs, exchange_recv(xs, op.ex_send_idx, mesh)],
                                1) if op.ex_L else xs
                y = y + torch.stack([g.gather_spmv(op.rest_cols[r],
                                                   op.rest_vals[r], src[r])
                                     for r in range(ndev)])
            left = mesh.shift_ring(xs[:, npr - w:], 1)
            right = mesh.shift_ring(xs[:, :w], -1)
            y = g.sharded_dia_corrections_plain(y, dv, left, right,
                                                op.offsets)
            assert torch.equal(tops.spmv(op, x), y.view(-1))

    def test_halo_op_reads_as_its_hybrid(self, mesh):
        from multigridsolver_tpu_torch.solve import smoothers as tsm
        h = shard_operator(thyb.hybrid_from_ell(
            tgen.poisson2d(40).to_ell(dtype=torch.float64, device="cpu")),
            mesh)
        op = make_halo_op(h, mesh)
        assert torch.equal(thyb.extract_diag(op), thyb.extract_diag(h))
        assert torch.equal(tsm.jacobi_diag(op, l1=True),
                           tsm.jacobi_diag(h, l1=True))
        # a halo wider than a shard (64 shards of 32 rows, lanes at ±40)
        # is read from the all-gathered x: the same SpMV
        wide_mesh = RowMesh(64, "cpu")
        hw = shard_operator(h, wide_mesh)
        assert halo_width(hw) > hw.npad // 64
        op = make_halo_op(hw, wide_mesh)
        assert spmv_route(op) == "all_gather"
        x = torch.from_numpy(np.random.RandomState(4).rand(hw.npad))
        torch.testing.assert_close(tops.spmv(op, x), thyb.spmv(hw, x),
                                   rtol=1e-14, atol=1e-14)


class TestShardedSetup:
    def test_f64_labels_and_levels_bitwise(self, jmesh, mesh):
        cfg_j = HierarchyConfig(max_coarse_size=32,
                                aggregation=AggregationConfig(**AGG))
        cfg_t = tcfg.HierarchyConfig(max_coarse_size=32,
                                     aggregation=tcfg.AggregationConfig(**AGG))
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("MGS_NO_WARMSET", "1")
            js = j_setup_sharded(jgen.poisson2d(32).to_ell(dtype=jnp.float64),
                                 cfg_j, jmesh)
        ell = tgen.poisson2d(32).to_ell(dtype=torch.float64, device="cpu")
        with k4_calls() as calls:
            ts = build_amg_setup_sharded(ell, cfg_t, mesh)
        assert ts.matrices[0].shard is not None and calls.call_count > 0
        assert ts.matrices[0].npad % (NDEV * 1024) == 0
        assert [m.nrows for m in ts.matrices] == [m.nrows
                                                  for m in js.matrices]
        n = ell.nrows
        for tl, jl in zip(ts.level_labels, js.level_labels):
            np.testing.assert_array_equal(tl.numpy()[:n],
                                          np.asarray(jl)[:n])
            assert (tl.numpy()[n:] == -1).all()
            n = int(np.asarray(jl).max()) + 1
        for tm, jm in zip(ts.matrices[1:], js.matrices[1:]):
            np.testing.assert_array_equal(tm.vals.numpy(), np.asarray(jm.vals))

    def test_f32_labels_and_levels_bitwise_under_interpreter(
            self, interp_ref, mesh):
        ell = tgen.poisson2d(64).to_ell(dtype=torch.float32, device="cpu")
        cfg = tcfg.HierarchyConfig(max_coarse_size=64,
                                   aggregation=tcfg.AggregationConfig(**AGG))
        ts = build_amg_setup_sharded(ell, cfg, mesh)
        assert ts.matrices[0].shard is not None
        assert [m.nrows for m in ts.matrices] == interp_ref["levels"]
        n = ell.nrows
        for tl, jl in zip(ts.level_labels, interp_ref["labels"]):
            np.testing.assert_array_equal(tl.numpy()[:n], jl[:n])
            n = int(jl.max()) + 1
        # and the unsharded port run of the same input
        ref = build_amg_setup(ell, cfg)
        for tl, rl in zip(ts.level_labels, ref.level_labels):
            m = min(rl.shape[0], tl.shape[0])
            assert torch.equal(tl[:m], rl[:m])


class TestShardedSolve:
    def test_iterations_equal_jax_shard_hierarchy(self, jmesh, mesh):
        """The JAX setup and λmax carried across, both hierarchies sharded
        (a HaloOp on level 0), BiCGStab to 1e-8: equal iteration counts,
        solutions equal to the solve's tolerance."""
        a = jgen.poisson2d(24)
        b = np.random.RandomState(0).rand(a.nrows)
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("MGS_NO_WARMSET", "1")
            s = j_setup(a.to_ell(dtype=jnp.float64), HierarchyConfig(
                max_coarse_size=32, aggregation=AggregationConfig(**AGG)))
            jh = j_build(s.matrices[0], s.level_labels, s.matrices[1:],
                         smoother_kind="chebyshev")
            jh_sh = j_shard_hier(jh, jmesh)
            npad = jh_sh.levels[0].a.npad
            jres = j_solve(jh_sh, j_shard_vector(
                j_pad(b, npad, jnp.float64), jmesh), method="bicgstab",
                tol=1e-8, maxiter=100)
        th = interop.hierarchy_from_numpy(
            [ell_dict(m) for m in s.matrices],
            [np.asarray(l) for l in s.level_labels],
            lmax_per_level=[float(l.smoother.lmax) for l in jh.levels],
            device="cpu", smoother_kind="chebyshev")
        th_sh = shard_hierarchy(th, mesh)
        assert isinstance(th_sh.levels[0].a, HaloOp)
        res = solve_hierarchy(th_sh, b, method="bicgstab", tol=1e-8,
                              maxiter=100)
        assert res.status == 0 and int(jres.status) == 0
        assert res.iterations == int(jres.iterations)
        np.testing.assert_allclose(res.x.numpy(),
                                   np.asarray(jres.x)[: a.nrows],
                                   rtol=1e-7, atol=1e-9)

    @pytest.mark.parametrize("ndev", [3, NDEV])
    def test_two_sharded_levels_match_unsharded(self, ndev):
        """poisson2d(64) f64, the bench's K-cycle, ``shard_levels=2``: a
        halo operator on levels 0 and 1 (level 1 with its remainder on the
        index-list exchange), the same preconditioner to rounding and the
        same BiCGStab iteration count.  On 3 shards the repadding grows
        npad, so labels, the smoother's diagonal and the transfers follow
        the new padding."""
        mesh = RowMesh(ndev, "cpu")
        ell = tgen.poisson2d(64).to_ell(dtype=torch.float64, device="cpu")
        cfg = tcfg.HierarchyConfig(max_coarse_size=512,
                                   aggregation=tcfg.AggregationConfig(
                                       ktg=10.0, npass=2, tou=8.0,
                                       symmetric=True))
        kw = dict(smoother_kind="chebyshev", cycle="kcycle", pre_smooth=1,
                  post_smooth=1, degree=2, kcycle_depth=3)
        s = build_amg_setup(ell, cfg)
        h = build_hierarchy(s.matrices[0], s.level_labels, s.matrices[1:],
                            **kw)
        hs = shard_hierarchy(h, mesh, shard_levels=2)
        assert [type(l.a) for l in hs.levels[:2]] == [HaloOp, HaloOp]
        assert hs.levels[1].a.route == "exchange"
        for l, lvl in enumerate(hs.levels[:2]):
            assert lvl.a.npad % (ndev * 8) == 0
            assert lvl.labels.shape[0] == lvl.smoother.d.shape[0] \
                == lvl.a.npad
        grew = hs.levels[0].a.npad != h.levels[0].a.npad
        assert grew == (ndev == 3)
        v = np.random.RandomState(1).rand(ell.nrows)
        z = h.precondition(pad_vector(v, h.levels[0].a.npad, torch.float64,
                                      "cpu"))
        zs = hs.precondition(pad_vector(v, hs.levels[0].a.npad,
                                        torch.float64, "cpu"))
        np.testing.assert_allclose(zs.numpy()[: ell.nrows],
                                   z.numpy()[: ell.nrows], rtol=1e-10,
                                   atol=1e-12 * float(z.abs().max()))
        b = np.random.RandomState(0).rand(ell.nrows)
        r = solve_hierarchy(h, b, method="bicgstab", tol=1e-6, maxiter=200)
        rs = solve_hierarchy(hs, b, method="bicgstab", tol=1e-6, maxiter=200)
        assert rs.status == 0 and rs.relres < 1e-6
        assert rs.iterations == r.iterations


def test_port_and_smoke_import_no_jax():
    """No module of the port, nor ``chip_smoke.py``, imports jax or the
    JAX package."""
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO,
                                               "multigridsolver_tpu_torch")):
        files += [os.path.join(root, f) for f in names if f.endswith(".py")]
    assert len(files) > 20
    for path in files:
        with open(path, encoding="utf-8") as fh:
            tree = ast.parse(fh.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                mods = [node.module or ""]
            else:
                continue
            for mod in mods:
                root = mod.split(".")[0]
                assert root not in ("jax", "jaxlib", "multigridsolver_tpu"), \
                    f"{os.path.relpath(path, REPO)} imports {mod}"
