"""The port's gather kernels (multigridsolver_tpu_torch/ops/gather.py).

On the CPU each wrapper runs its plain PyTorch version; these tests hold
that version against the JAX package's Pallas kernel (run through the
Pallas interpreter) and a plain numpy gather.  The CUDA kernels
themselves are tested on a GPU by ``test_torch_cuda.py``.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from multigridsolver_tpu.ops import gather_pallas as gp
from multigridsolver_tpu_torch.ops import gather as g

T = 1024


def banded_ell_arrays(n, K, band, seed=0):
    """Slot-major (K, npad) banded ELL arrays with ragged rows; invalid
    slots hold col 0 / val 0."""
    rs = np.random.RandomState(seed)
    npad = ((n + T - 1) // T) * T
    rows = np.arange(npad)
    cols = np.clip(rows[None, :] + rs.randint(-band, band + 1, (K, npad)),
                   0, n - 1).astype(np.int32)
    vals = rs.rand(K, npad)
    rownnz = rs.randint(1, K + 1, npad).astype(np.int32)
    rownnz[n:] = 0
    valid = np.arange(K)[:, None] < rownnz[None, :]
    cols[~valid] = 0
    vals[~valid] = 0.0
    return cols, vals, rownnz, valid


@pytest.fixture
def interpret(monkeypatch):
    """Run the Pallas kernels through the interpreter (the wrappers are
    jitted with the flag baked in: clear their caches both ways)."""
    fns = (gp.windowed_gather_spmv, gp.windowed_take, gp.windowed_take_rows)
    monkeypatch.setattr(gp, "INTERPRET", True)
    for fn in fns:
        fn.clear_cache()
    yield
    for fn in fns:
        fn.clear_cache()


class TestK1GatherSpmv:
    def test_plain_matches_pallas_and_numpy_f32(self, interpret):
        n, K = 4000, 6
        cols, vals, rownnz, _ = banded_ell_arrays(n, K, band=400, seed=1)
        vals = vals.astype(np.float32)
        x = np.random.RandomState(2).rand(n).astype(np.float32)
        base_blk, wr, nsrc_pad = gp.plan_windows(cols, rownnz, n)
        y_pallas = np.asarray(gp.windowed_gather_spmv(
            jnp.asarray(cols), jnp.asarray(vals), jnp.asarray(x),
            jnp.asarray(base_blk), wr, nsrc_pad))
        y = g.gather_spmv(torch.from_numpy(cols), torch.from_numpy(vals),
                          torch.from_numpy(x)).numpy()
        ref = (vals * x[cols]).sum(axis=0)
        np.testing.assert_allclose(y, y_pallas, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(y, ref, rtol=1e-6, atol=1e-6)

    def test_plain_matches_numpy_f64(self):
        n, K = 3000, 9
        cols, vals, _, _ = banded_ell_arrays(n, K, band=700, seed=3)
        x = np.random.RandomState(4).rand(n)
        y = g.gather_spmv(torch.from_numpy(cols), torch.from_numpy(vals),
                          torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(y, (vals * x[cols]).sum(axis=0),
                                   rtol=1e-12, atol=1e-12)

    def test_rejects_mismatched_dtypes(self):
        cols, vals, _, _ = banded_ell_arrays(100, 3, band=5)
        with pytest.raises(ValueError):
            g.gather_spmv(torch.from_numpy(cols),
                          torch.from_numpy(vals).float(),
                          torch.zeros(100, dtype=torch.float64))
        with pytest.raises(ValueError):
            g.gather_spmv(torch.from_numpy(cols).long(),
                          torch.from_numpy(vals),
                          torch.zeros(100, dtype=torch.float64))


class TestK2Take:
    @pytest.mark.parametrize("dtype", [np.float32, np.int32])
    def test_slot_field_matches_pallas_on_valid_slots(self, interpret, dtype):
        n, K = 5000, 5
        cols, _, rownnz, valid = banded_ell_arrays(n, K, band=300, seed=5)
        rs = np.random.RandomState(6)
        x = (rs.rand(n) * 1000).astype(dtype)
        base_blk, wr, nsrc = gp.plan_windows(cols, rownnz, n,
                                             include_identity=True)
        out_pallas = np.asarray(gp.windowed_take(
            jnp.asarray(cols), jnp.asarray(x), jnp.asarray(base_blk), wr,
            nsrc))
        out = g.take(torch.from_numpy(cols), torch.from_numpy(x)).numpy()
        assert out.dtype == x.dtype and out.shape == cols.shape
        np.testing.assert_array_equal(out[valid], out_pallas[valid])
        np.testing.assert_array_equal(out, x[cols])

    @pytest.mark.parametrize("dtype", [np.float32, np.int32, np.float64])
    def test_index_vector_with_sentinels(self, interpret, dtype):
        n = 5000
        cols, _, rownnz, valid = banded_ell_arrays(n, 4, band=200, seed=7)
        rs = np.random.RandomState(8)
        # a 1-D index drawn from stored columns (in-window), with -1s
        idx = cols[0].copy()
        sentinel = (rs.rand(idx.shape[0]) < 0.1) | ~valid[0]
        idx[sentinel] = -1
        x = (rs.rand(n) * 1000).astype(dtype)
        out = g.take(torch.from_numpy(idx), torch.from_numpy(x)).numpy()
        # -1 is clamped to 0 in both the kernel and its plain version
        np.testing.assert_array_equal(out, x[np.clip(idx, 0, n - 1)])
        if dtype != np.float64:      # the Pallas kernel takes 4-byte words
            base_blk, wr, nsrc = gp.plan_windows(cols, rownnz, n,
                                                 include_identity=True)
            out_pallas = np.asarray(gp.windowed_take(
                jnp.asarray(idx[None, :]), jnp.asarray(x),
                jnp.asarray(base_blk), wr, nsrc))[0]
            np.testing.assert_array_equal(out[~sentinel],
                                          out_pallas[~sentinel])

    def test_rejects_bool_and_int64_index(self):
        # a bool field is a source K2 takes; a bool or int64 index, and a
        # source of 2-byte words, are refused
        with pytest.raises(ValueError):
            g.take(torch.zeros(4, dtype=torch.bool),
                   torch.zeros(4, dtype=torch.bool))
        with pytest.raises(ValueError):
            g.take(torch.zeros(4, dtype=torch.int64), torch.zeros(4))
        with pytest.raises(ValueError):
            g.take(torch.zeros(4, dtype=torch.int32),
                   torch.zeros(4, dtype=torch.float16))

    @pytest.mark.parametrize("dtype", [torch.bool, torch.uint8, torch.int8])
    def test_one_byte_words_equal_int32_round_trip(self, dtype):
        """A 1-byte source gathered as it is gives the bits of the old
        route through int32 (convert, gather, convert back)."""
        n = 3000
        cols, _, _, _ = banded_ell_arrays(n, 5, band=100, seed=14)
        rs = np.random.RandomState(15)
        idx1 = rs.randint(-1, n, 2051).astype(np.int32)   # n % 4 != 0
        x = torch.from_numpy(rs.randint(-128, 256, n)).to(dtype)
        for idx in (torch.from_numpy(cols), torch.from_numpy(idx1)):
            out = g.take(idx, x)
            old = g.take(idx, x.to(torch.int32))
            old = old != 0 if dtype == torch.bool else old.to(dtype)
            assert out.dtype == dtype and out.shape == idx.shape
            assert torch.equal(out, old)
            assert torch.equal(out.view(torch.uint8), old.view(torch.uint8))

    def test_bool_field_matches_pallas(self, interpret):
        """The JAX package gathers a bool field as int32 through
        ``windowed_take`` and compares with 0; K2 takes it as bytes."""
        n, K = 5000, 5
        cols, _, rownnz, valid = banded_ell_arrays(n, K, band=300, seed=16)
        x = np.random.RandomState(17).rand(n) < 0.5
        base_blk, wr, nsrc = gp.plan_windows(cols, rownnz, n,
                                             include_identity=True)
        out_pallas = np.asarray(gp.windowed_take(
            jnp.asarray(cols), jnp.asarray(x.astype(np.int32)),
            jnp.asarray(base_blk), wr, nsrc)) != 0
        out = g.take(torch.from_numpy(cols), torch.from_numpy(x)).numpy()
        assert out.dtype == np.bool_
        np.testing.assert_array_equal(out[valid], out_pallas[valid])
        np.testing.assert_array_equal(out, x[cols])


class TestK3TakeRows:
    @pytest.mark.parametrize("dtype", [np.float32, np.int32])
    def test_matches_pallas_and_numpy(self, interpret, dtype):
        nsrc, nc, S = 6000, 3000, 9
        rs = np.random.RandomState(9)
        # member indices: ~2 fine rows per coarse row, like a pairwise pass
        idx = np.clip(2 * np.arange(nc) + rs.randint(0, 2, nc), 0,
                      nsrc - 1).astype(np.int32)
        npad_c = ((nc + T - 1) // T) * T
        idx = np.concatenate([idx, np.zeros(npad_c - nc, np.int32)])
        xs = (rs.rand(S, nsrc) * 1000).astype(dtype)
        plan = gp.plan_windows(idx[None, :], np.ones(npad_c, np.int32), nsrc)
        base_blk, wr, nsrc_pad = plan
        out_pallas = np.asarray(gp.windowed_take_rows(
            jnp.asarray(idx), jnp.asarray(xs), jnp.asarray(base_blk), wr,
            nsrc_pad))
        out = g.take_rows(torch.from_numpy(idx), torch.from_numpy(xs)).numpy()
        assert out.shape == (S, npad_c) and out.dtype == xs.dtype
        np.testing.assert_array_equal(out, out_pallas)
        np.testing.assert_array_equal(out, xs[:, idx])

    def test_f64_and_sentinels(self):
        rs = np.random.RandomState(10)
        xs = rs.rand(3, 500)
        idx = rs.randint(-1, 500, 2048).astype(np.int32)
        out = g.take_rows(torch.from_numpy(idx), torch.from_numpy(xs)).numpy()
        np.testing.assert_array_equal(out, xs[:, np.clip(idx, 0, 499)])

    def test_many_equals_per_source_and_pallas(self, interpret):
        """The Galerkin member fetch's sources in one call (relabelled
        columns int32, values f64, row lengths int32, a fourth f32 field):
        each output equals ``take_rows`` of its source and, for the 4-byte
        sources the Pallas kernel takes, the interpreter's
        ``windowed_take_rows``."""
        nsrc, nc = 6000, 3000
        rs = np.random.RandomState(18)
        idx = np.clip(2 * np.arange(nc) + rs.randint(0, 2, nc), 0,
                      nsrc - 1).astype(np.int32)
        npad_c = ((nc + T - 1) // T) * T
        idx = np.concatenate([idx, np.zeros(npad_c - nc, np.int32)])
        sources = [rs.randint(-1, 2000, (9, nsrc)).astype(np.int32),
                   rs.rand(9, nsrc),
                   rs.randint(0, 10, (1, nsrc)).astype(np.int32),
                   rs.rand(2, nsrc).astype(np.float32)]
        ti = torch.from_numpy(idx)
        outs = g.take_rows_many(ti, [torch.from_numpy(x) for x in sources])
        base_blk, wr, nsrc_pad = gp.plan_windows(
            idx[None, :], np.ones(npad_c, np.int32), nsrc)
        assert len(outs) == len(sources)
        for out, xs in zip(outs, sources):
            assert out.dtype == torch.from_numpy(xs).dtype
            assert torch.equal(out, g.take_rows(ti, torch.from_numpy(xs)))
            np.testing.assert_array_equal(out.numpy(), xs[:, idx])
            if xs.dtype.itemsize == 4:
                np.testing.assert_array_equal(out.numpy(), np.asarray(
                    gp.windowed_take_rows(jnp.asarray(idx), jnp.asarray(xs),
                                          jnp.asarray(base_blk), wr,
                                          nsrc_pad)))

    def test_many_refuses_what_the_kernel_does_not_take(self):
        idx = torch.zeros(8, dtype=torch.int32)
        xs = torch.zeros(2, 16)
        with pytest.raises(ValueError):          # five sources
            g.take_rows_many(idx, [xs] * 5)
        with pytest.raises(ValueError):          # no source
            g.take_rows_many(idx, [])
        with pytest.raises(ValueError):          # another nsrc
            g.take_rows_many(idx, [xs, torch.zeros(2, 17)])
        with pytest.raises(ValueError):          # 2-byte words
            g.take_rows_many(idx, [xs, torch.zeros(2, 16,
                                                   dtype=torch.float16)])
        with pytest.raises(ValueError):          # 1-byte words
            g.take_rows_many(idx, [torch.zeros(2, 16, dtype=torch.bool)])


class TestRouting:
    def test_cpu_tensors_take_plain_version_and_count_nothing(self):
        g.reset_launch_counts()
        cols, vals, _, _ = banded_ell_arrays(2000, 4, band=50, seed=11)
        tc, tv = torch.from_numpy(cols), torch.from_numpy(vals)
        x = torch.from_numpy(np.random.RandomState(12).rand(2000))
        assert torch.equal(g.gather_spmv(tc, tv, x),
                           g.gather_spmv_plain(tc, tv, x))
        assert torch.equal(g.take(tc, x), g.take_plain(tc, x))
        assert torch.equal(g.take_rows(tc[0], tv), g.take_rows_plain(tc[0],
                                                                     tv))
        many = g.take_rows_many(tc[0], [tc, tv])
        assert all(torch.equal(a, b) for a, b in
                   zip(many, g.take_rows_many_plain(tc[0], [tc, tv])))
        xb = x > 0.5
        assert torch.equal(g.take(tc, xb), g.take_plain(tc, xb))
        lanes = g.pack_lanes((-1, 0, 1))
        dv = tv[:3].contiguous()
        xp = torch.from_numpy(np.random.RandomState(13).rand(tc.shape[1]))
        assert torch.equal(g.hyb_spmv(dv, lanes, tc, tv, xp),
                           g.hyb_spmv_plain(dv, lanes, tc, tv, xp))
        halo = g.halo_fill(xp, 4, 50)
        assert torch.equal(halo, g.halo_fill_plain(xp, 4, 50))
        assert torch.equal(g.take_sharded(tc, xp, halo, tc.shape[1] // 4, 50),
                           g.take_sharded_plain(tc, xp, halo,
                                                tc.shape[1] // 4, 50))
        assert torch.equal(
            g.hyb_spmv_sharded(dv, lanes, xp, 4, halo=halo),
            g.hyb_spmv_sharded_plain(dv, lanes, xp, 4, halo=halo))
        assert g.launch_counts() == {"gather_spmv": 0, "hyb_spmv": 0,
                                     "take": 0, "take_rows": 0,
                                     "take_rows_many": 0,
                                     "take_sharded": 0, "halo_fill": 0,
                                     "hyb_spmv_sharded": 0}


def sharded_operator(ndev, npr, offsets, K, band, seed):
    """A random f64 operator over ndev shards of npr rows: DIA lanes at
    ``offsets`` (0 where i + o leaves the rows) and a slot-major ELL
    remainder of K slots within ``band`` of the diagonal, as a global
    ``(K, npad)`` ELL and as per-shard blocks ``(ndev, K, npr)``."""
    rs = np.random.RandomState(seed)
    npad = ndev * npr
    rows = np.arange(npad)
    dvals = rs.rand(len(offsets), npad)
    for d, o in enumerate(offsets):
        dvals[d, (rows + o < 0) | (rows + o >= npad)] = 0.0
    cols, vals, _, _ = banded_ell_arrays(npad, K, band, seed=seed + 1)
    cols, vals = cols[:, :npad], vals[:, :npad]
    blocks = [torch.from_numpy(np.ascontiguousarray(
        t.reshape(K, ndev, npr).transpose(1, 0, 2))) for t in (cols, vals)]
    return (torch.from_numpy(dvals), g.pack_lanes(offsets),
            torch.from_numpy(np.ascontiguousarray(cols)),
            torch.from_numpy(np.ascontiguousarray(vals)), blocks,
            torch.from_numpy(rs.rand(npad)))


class TestShardedSpMV:
    """K1 on a row mesh (``hyb_spmv_sharded``): its plain version, which
    the wrapper takes on the CPU, computes the unsharded operator's SpMV
    on every remainder route.  (Its bits against the route it replaced and
    against the JAX package's sharded SpMV: ``test_torch_parallel.py``.)"""

    @pytest.mark.parametrize("route", ["none", "all_gather", "exchange"])
    @pytest.mark.parametrize("ndev,npr", [(4, 512), (3, 337), (1, 1000)])
    def test_equals_unsharded_spmv(self, route, ndev, npr):
        from multigridsolver_tpu_torch.parallel.exchange import (
            build_exchange_plan)
        offsets = (-40, -1, 0, 1, 40)
        dv, lanes, cols, vals, (cb, vb), x = sharded_operator(
            ndev, npr, offsets, 3, 60, seed=ndev)
        w = 40
        halo = g.halo_fill(x, ndev, w)
        kw = dict(halo=halo, route=route)
        if route == "none":
            ref = g.hyb_spmv_plain(dv, lanes, None, None, x)
        else:
            ref = g.hyb_spmv_plain(dv, lanes, cols, vals, x)
            kw.update(cols=cb, vals=vb)
        if route == "exchange":
            plan = build_exchange_plan(cols.numpy(),
                                       np.full(ndev * npr, 3, np.int32), ndev)
            assert plan is not None
            kw["cols"] = torch.from_numpy(np.ascontiguousarray(
                plan.cols.reshape(3, ndev, npr).transpose(1, 0, 2)))
            send = torch.from_numpy(plan.send_idx).long()
            if plan.L:
                sv = torch.gather(x.view(ndev, npr), 1, send.view(ndev, -1))
                kw["recv"] = sv.view(send.shape).transpose(0, 1) \
                    .reshape(ndev, -1)
        y = g.hyb_spmv_sharded(dv, lanes, x, ndev, **kw)
        assert y.shape == x.shape and y.dtype == x.dtype
        torch.testing.assert_close(y, ref, rtol=1e-12, atol=1e-12)

    def test_without_lanes_is_the_remainder_alone(self):
        """D = 0 (the ``ExchangeELL`` case): the interior is +0, so the
        result is the per-shard ELL SpMV bit for bit."""
        ndev, npr = 4, 256
        _, _, cols, vals, (cb, vb), x = sharded_operator(ndev, npr, (0,), 5,
                                                         30, seed=7)
        y = g.hyb_spmv_sharded(None, g.NO_LANES, x, ndev, cols=cb, vals=vb,
                               route="all_gather")
        assert torch.equal(y, g.gather_spmv_plain(cols, vals, x))

    def test_rejects_what_the_kernel_does_not_take(self):
        dv, lanes, cols, vals, (cb, vb), x = sharded_operator(
            4, 64, (-8, 0, 8), 2, 10, seed=3)
        halo = g.halo_fill(x, 4, 8)
        with pytest.raises(ValueError):          # no such route
            g.hyb_spmv_sharded(dv, lanes, x, 4, halo=halo, route="ring")
        with pytest.raises(ValueError):          # halo narrower than offsets
            g.hyb_spmv_sharded(dv, lanes, x, 4, halo=g.halo_fill(x, 4, 4))
        with pytest.raises(ValueError):          # off-shard lanes, no halo
            g.hyb_spmv_sharded(dv, lanes, x, 4)
        with pytest.raises(ValueError):          # remainder on route none
            g.hyb_spmv_sharded(dv, lanes, x, 4, halo=halo, cols=cb, vals=vb)
        with pytest.raises(ValueError):          # global (K, npad) cols
            g.hyb_spmv_sharded(dv, lanes, x, 4, halo=halo, cols=cols,
                               vals=vals, route="all_gather")
        with pytest.raises(ValueError):          # recv off the exchange
            g.hyb_spmv_sharded(dv, lanes, x, 4, halo=halo, cols=cb, vals=vb,
                               recv=x.view(4, -1), route="all_gather")
        with pytest.raises(ValueError):          # x does not split
            g.hyb_spmv_sharded(dv[:, :255], lanes, x[:255], 4, halo=halo)
        with pytest.raises(ValueError):          # 2-byte words
            g.halo_fill(x.half(), 4, 8)
        with pytest.raises(ValueError):          # halo wider than a shard
            g.halo_fill(x, 4, 65)
