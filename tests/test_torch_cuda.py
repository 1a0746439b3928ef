"""The port on a GPU: the CUDA kernels against their plain versions, and
the main path on the card against the same path on the CPU.

Every test here needs a CUDA device and skips without one.  The module
imports no jax, so it also runs on a machine without it:

    python -m pytest --noconftest -o addopts="" tests/test_torch_cuda.py
"""
import dataclasses
import gc

import numpy as np
import pytest
import torch

from multigridsolver_tpu_torch.cli.generators import csky3d, poisson2d
from multigridsolver_tpu_torch.ops import gather as g
from multigridsolver_tpu_torch.parallel import (RowMesh,
                                                build_amg_setup_sharded,
                                                shard_ell_halo,
                                                shard_hierarchy)
from multigridsolver_tpu_torch.setup.aggregation import build_amg_setup
from multigridsolver_tpu_torch.solve import hierarchy as hierarchy_mod
from multigridsolver_tpu_torch.solve import krylov
from multigridsolver_tpu_torch.solve.api import (pad_vector,
                                                 solve_hierarchy,
                                                 solve_refined)
from multigridsolver_tpu_torch.solve.hierarchy import _cycle, build_hierarchy
from multigridsolver_tpu_torch.sparse import ops
from multigridsolver_tpu_torch.sparse.hybrid import hybrid_from_ell
from multigridsolver_tpu_torch.utils import timing
from multigridsolver_tpu_torch.utils.config import (BENCH_HIERARCHY,
                                                    CSKY_REFINE,
                                                    bench_config,
                                                    csky_config)

pytestmark = pytest.mark.cuda


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def banded(rs, n, k, band):
    npad = (n + 1023) // 1024 * 1024
    cols = np.clip(np.arange(npad)[None, :]
                   + rs.randint(-band, band + 1, (k, npad)), 0, n - 1)
    rownnz = rs.randint(1, k + 1, npad)
    rownnz[n:] = 0
    valid = np.arange(k)[:, None] < rownnz[None, :]
    return (np.where(valid, cols, 0).astype(np.int32),
            np.where(valid, rs.rand(k, npad), 0.0))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kernels_match_plain_versions(device, dtype):
    rs = np.random.RandomState(13)
    cols, vals = banded(rs, 50000, 7, 900)
    tc = torch.from_numpy(cols).to(device)
    tv = torch.from_numpy(vals).to(device, dtype)
    x = torch.from_numpy(rs.rand(50000)).to(device, dtype)
    idx = torch.from_numpy(rs.randint(-1, 50000, 4096).astype(np.int32)
                           ).to(device)
    g.reset_launch_counts()
    y = g.gather_spmv(tc, tv, x)
    tol = 1e-6 if dtype == torch.float32 else 1e-12
    torch.testing.assert_close(y, g.gather_spmv_plain(tc, tv, x), rtol=tol,
                               atol=tol)
    assert torch.equal(g.take(tc, x), g.take_plain(tc, x))
    assert torch.equal(g.take(idx, x), g.take_plain(idx, x))
    assert torch.equal(g.take_rows(idx, tv), g.take_rows_plain(idx, tv))
    torch.cuda.synchronize()
    assert g.launch_counts() == {"gather_spmv": 1, "hyb_spmv": 0, "take": 2,
                                 "take_rows": 1, "take_rows_many": 0,
                                 "take_sharded": 0, "halo_fill": 0,
                                 "hyb_spmv_sharded": 0}


def words(rs, n, dtype, device):
    """n random words of ``dtype`` (every bit pattern for the integers)."""
    if dtype == torch.bool:
        return torch.from_numpy(rs.rand(n) < 0.5).to(device)
    if dtype.is_floating_point:
        return torch.from_numpy(rs.rand(n)).to(device, dtype)
    info = torch.iinfo(dtype)
    return torch.from_numpy(rs.randint(info.min, info.max, n,
                                       dtype=np.int64)).to(device, dtype)


WORD_DTYPES = [torch.bool, torch.uint8, torch.int8, torch.int32,
               torch.float32, torch.float64, torch.int64]


@pytest.mark.parametrize("dtype", WORD_DTYPES)
def test_take_routes_match_plain_version(device, dtype):
    """K2 on each route, bitwise its plain version: the vector route on a
    (K, npad) slot field and on a 1-D index with -1 sentinels, with a
    tail past the last word group, and the scalar route on an index view
    at a 4-byte offset; bool in gives bool out."""
    rs = np.random.RandomState(23)
    nsrc = 40000
    x = words(rs, nsrc, dtype, device)
    cols, _ = banded(rs, nsrc, 5, 700)
    flat = torch.from_numpy(rs.randint(-1, nsrc, 10007).astype(np.int32)
                            ).to(device)
    cases = [(torch.from_numpy(cols).to(device), "vector"),
             (flat[:10000], "vector"),          # n % 4 == 0
             (flat[:9999], "vector"),           # a tail of 3
             (flat[:1], "vector"),              # the tail alone
             (flat[1:], "scalar"),              # idx at a 4-byte offset
             (flat[3:], "scalar")]
    g.reset_launch_counts()
    for idx, route in cases:
        assert g.take_route(idx, x) == route
        out = g.take(idx, x)
        ref = g.take_plain(idx, x)
        assert out.dtype == dtype and out.shape == idx.shape
        assert torch.equal(out.view(-1).view(torch.uint8),
                           ref.view(-1).view(torch.uint8))
    torch.cuda.synchronize()
    assert g.launch_counts()["take"] == len(cases)


def test_take_bool_equals_int32_round_trip(device):
    """A bool field taken as bytes gives the old route's bits (convert
    to int32, gather, compare with 0)."""
    rs = np.random.RandomState(29)
    x = torch.from_numpy(rs.rand(30000) < 0.3).to(device)
    cols, _ = banded(rs, 30000, 5, 500)
    idx = torch.from_numpy(cols).to(device)
    assert torch.equal(g.take(idx, x), g.take(idx, x.to(torch.int32)) != 0)


@pytest.mark.parametrize("nsources", [1, 2, 3, 4])
def test_take_rows_many_routes_match_plain_version(device, nsources):
    """K3 with 1 to 4 sources of mixed 4- and 8-byte words, bitwise its
    plain version, on the vector route (n % 4 == 0), the scalar route
    (n % 4 != 0, and an index view at a 4-byte offset), with -1
    sentinels; ``take_rows`` is the same kernel with one source."""
    rs = np.random.RandomState(31 + nsources)
    nsrc = 30000
    kinds = [(9, torch.int32), (9, torch.float64), (1, torch.int32),
             (3, torch.float32)][:nsources]
    sources = [words(rs, S * nsrc, dt, device).view(S, nsrc)
               for S, dt in kinds]
    flat = torch.from_numpy(rs.randint(-1, nsrc, 8193).astype(np.int32)
                            ).to(device)
    cases = [(flat[:8192], "vector"), (flat[:8191], "scalar"),
             (flat[1:], "scalar"), (flat[1:8189], "scalar")]
    g.reset_launch_counts()
    for idx, route in cases:
        assert g.take_rows_route(idx, sources) == route
        outs = g.take_rows_many(idx, sources)
        for out, xs, ref in zip(outs, sources,
                                g.take_rows_many_plain(idx, sources)):
            assert out.dtype == xs.dtype
            assert out.shape == (xs.shape[0], idx.shape[0])
            assert torch.equal(out, ref)
        assert torch.equal(g.take_rows(idx, sources[0]), outs[0])
    torch.cuda.synchronize()
    assert g.launch_counts()["take_rows_many"] == len(cases)
    assert g.launch_counts()["take_rows"] == len(cases)


def old_route(dvals, lanes, cols, vals, x):
    """The hybrid SpMV as the card ran it before K1 took the lanes: the
    torch lane loop, then K1 without lanes for the remainder."""
    y = g.hyb_spmv_plain(dvals, lanes, None, None, x)
    return y if cols is None else y.add_(g.gather_spmv(cols, vals, x))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_hyb_spmv_matches_plain_and_old_route(device, dtype):
    """K1 with lanes on every level of poisson2d(96) (x window in shared
    memory), on wide offsets (lanes through __ldg) and on an odd npad
    (one row per thread): bitwise the old route, and its plain version
    to rtol 1e-6 (f32) / 1e-12 (f64)."""
    rs = np.random.RandomState(19)
    s = build_amg_setup(poisson2d(96).to_ell(dtype=dtype, device=device),
                        bench_config())
    ops = [hybrid_from_ell(m) for m in s.matrices]
    cases = [(h.dvals, h.lanes, None if h.ell is None else h.ell.cols,
              None if h.ell is None else h.ell.vals) for h in ops]
    for npad, offs in [(65536, (-20000, -1, 0, 1, 20000)),
                       (4099, (-70, -1, 0, 1, 70))]:
        cols, vals = banded(rs, npad, 3, 200)
        cases.append((torch.from_numpy(rs.rand(len(offs), npad)).to(device,
                                                                     dtype),
                      g.pack_lanes(offs),
                      torch.from_numpy(cols[:, :npad].copy()).to(device),
                      torch.from_numpy(vals[:, :npad].copy()).to(device,
                                                                 dtype)))
    tol = 1e-6 if dtype == torch.float32 else 1e-12
    routes = []
    for dv, lanes, cols, vals in cases:
        x = torch.from_numpy(rs.rand(dv.shape[1])).to(device, dtype)
        routes.append(g.hyb_route(dv, lanes, cols, vals, x))
        g.reset_launch_counts()
        y = g.hyb_spmv(dv, lanes, cols, vals, x)
        assert g.launch_counts()["hyb_spmv"] == 1
        assert torch.equal(y, old_route(dv, lanes, cols, vals, x))
        torch.testing.assert_close(
            y, g.hyb_spmv_plain(dv, lanes, cols, vals, x), rtol=tol,
            atol=tol)
    assert routes[-2:] == ["vector", "scalar"]
    assert {r for r, case in zip(routes[:-2], cases) if case[1].d} \
        == {"window"}


def test_kernels_reject_what_they_do_not_take(device):
    x = torch.zeros(8, device=device)
    with pytest.raises(ValueError):          # mixed devices
        g.take(torch.zeros(4, dtype=torch.int32), x)
    with pytest.raises(ValueError):          # non-contiguous source
        g.take(torch.zeros(4, dtype=torch.int32, device=device),
               torch.zeros(16, device=device)[::2])


@pytest.mark.parametrize("dtype", WORD_DTYPES)
def test_k4_matches_plain_version(device, dtype):
    """K4 on the sharded poisson2d(200) ELL (4 shards), bitwise its plain
    version on every route: the vector route on the stored columns and on
    a 1-D index with -1 sentinels, the scalar route on index views at a
    4-byte offset; 1-, 4- and 8-byte words, bool in gives bool out.  The
    halo comes from one ``halo_fill`` launch, equal to its plain
    version."""
    a = shard_ell_halo(poisson2d(200).to_ell(dtype=torch.float32,
                                             device=device),
                       RowMesh(4, device))
    mesh, npr, h = a.shard
    rs = np.random.RandomState(17)
    x = words(rs, a.npad, dtype, device)
    g.reset_launch_counts()
    halo = mesh.boundary_halo(x, h)
    assert torch.equal(halo, g.halo_fill_plain(x, mesh.ndev, h))
    idx1 = torch.where(torch.from_numpy(rs.rand(a.npad) < 0.1).to(device),
                       -1, a.cols[1]).to(torch.int32).contiguous()
    cases = [(a.cols, "vector"), (idx1, "vector"),
             (unaligned(a.cols), "scalar"), (unaligned(idx1), "scalar")]
    for idx, route in cases:
        assert g.take_sharded_route(idx, x, halo, npr, h) == route
        out = g.take_sharded(idx, x, halo, npr, h)
        ref = g.take_sharded_plain(idx, x, halo, npr, h)
        assert out.dtype == dtype and out.shape == idx.shape
        assert torch.equal(out.view(-1).view(torch.uint8),
                           ref.view(-1).view(torch.uint8))
    valid = a.slot_mask()
    assert torch.equal(g.take_sharded(a.cols, x, halo, npr, h)[valid],
                       x[a.cols.long()][valid])
    torch.cuda.synchronize()
    assert g.launch_counts()["take_sharded"] == len(cases) + 1
    assert g.launch_counts()["halo_fill"] == 1


@pytest.mark.parametrize("dtype", WORD_DTYPES)
def test_k4_and_halo_fill_on_a_ranks_block(device, dtype):
    """A rank's block of the sharded poisson2d(200) ELL (4 shards, the
    middle two held by this rank): the halo fill with the neighbour
    ranks' edge slabs as its outer edges, K4 with the rank's first row as
    its base, each bitwise its plain version and the one-process mesh's
    halo and gather on every route; one outer edge alone, too."""
    whole = shard_ell_halo(poisson2d(200).to_ell(dtype=torch.float32,
                                                 device=device),
                           RowMesh(4, device))
    _, npr, h = whole.shard
    lo_row, hi_row = npr, 3 * npr
    rs = np.random.RandomState(19)
    x = words(rs, whole.npad, dtype, device)
    xl = x[lo_row:hi_row].contiguous()
    left = x[lo_row - h:lo_row].contiguous()
    right = x[hi_row:hi_row + h].contiguous()
    g.reset_launch_counts()
    halo = g.halo_fill(xl, 2, h, left, right)
    assert torch.equal(halo, g.halo_fill_plain(xl, 2, h, left, right))
    assert torch.equal(halo, g.halo_fill_plain(x, 4, h)[1:3])
    for lo, hi in ((left, None), (None, right)):
        assert torch.equal(g.halo_fill(xl, 2, h, lo, hi),
                           g.halo_fill_plain(xl, 2, h, lo, hi))
    cols = whole.cols[:, lo_row:hi_row].contiguous()
    valid = whole.slot_mask()[:, lo_row:hi_row]
    for idx, route in ((cols, "vector"), (unaligned(cols), "scalar")):
        assert g.take_sharded_route(idx, xl, halo, npr, h) == route
        out = g.take_sharded(idx, xl, halo, npr, h, base=lo_row)
        ref = g.take_sharded_plain(idx, xl, halo, npr, h, lo_row)
        assert torch.equal(out.view(-1).view(torch.uint8),
                           ref.view(-1).view(torch.uint8))
        assert torch.equal(out[valid], x[idx.long()][valid])
    torch.cuda.synchronize()
    assert g.launch_counts()["halo_fill"] == 3
    assert g.launch_counts()["take_sharded"] == 2


def unaligned(idx):
    """A copy of ``idx`` 4 bytes off 16-byte alignment."""
    buf = torch.empty(idx.numel() + 1, dtype=idx.dtype, device=idx.device)
    out = buf[1:].view(idx.shape)
    out.copy_(idx)
    return out


def sharded_cases(device, dtype):
    """The sharded SpMV's inputs on every route, from the two halo levels
    of poisson2d(96) on 4 shards (npr a multiple of 8, not of 1024) and a
    random operator with an odd npr (one row a thread)."""
    from multigridsolver_tpu_torch.parallel.exchange import exchange_recv
    from multigridsolver_tpu_torch.parallel.halo import (halo_width,
                                                         make_halo_op)
    from multigridsolver_tpu_torch.parallel.sharded import shard_operator
    mesh = RowMesh(4, device)
    s = build_amg_setup(poisson2d(96).to_ell(dtype=dtype, device=device),
                        bench_config())
    rs = np.random.RandomState(41)
    cases = []
    for lvl in range(2):
        op = make_halo_op(shard_operator(hybrid_from_ell(s.matrices[lvl]),
                                         mesh), mesh)
        x = torch.from_numpy(rs.rand(op.npad)).to(device, dtype)
        w = halo_width(op.a)
        recv = exchange_recv(x.view(4, -1), op.ex_send_idx, mesh) \
            if op.ex_L else None
        cases.append((op.a.dvals, op.a.lanes, x, 4,
                      dict(halo=mesh.boundary_halo(x, w), cols=op.rest_cols,
                           vals=op.rest_vals, recv=recv, route=op.route)))
        if op.rest_cols is not None:      # the same remainder, global x
            glob = op.a.ell.cols.view(op.a.ell.k, 4, -1).transpose(0, 1) \
                .contiguous()
            cases.append((op.a.dvals, op.a.lanes, x, 4,
                          dict(halo=cases[-1][4]["halo"], cols=glob,
                               vals=op.rest_vals, route="all_gather")))
    ndev, npr, offs = 3, 4099, (-70, -1, 0, 1, 70)
    cols, vals = banded(rs, ndev * npr, 3, 200)
    cb = torch.from_numpy(np.ascontiguousarray(
        cols[:, :ndev * npr].reshape(3, ndev, npr).transpose(1, 0, 2))
    ).to(device)
    vb = torch.from_numpy(np.ascontiguousarray(
        vals[:, :ndev * npr].reshape(3, ndev, npr).transpose(1, 0, 2))
    ).to(device, dtype)
    x = torch.from_numpy(rs.rand(ndev * npr)).to(device, dtype)
    cases.append((torch.from_numpy(rs.rand(len(offs), ndev * npr)).to(
        device, dtype), g.pack_lanes(offs), x, ndev,
        dict(halo=g.halo_fill(x, ndev, 72), cols=cb, vals=vb,
             route="all_gather")))
    return cases


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_hyb_spmv_sharded_matches_plain_version(device, dtype):
    """K1 on a row mesh on every route (pure DIA; 48 lanes with the
    exchanged remainder read in place; the same remainder from the global
    x; an odd npr on the one-row route; no lanes), one launch each,
    bitwise its plain version."""
    cases = sharded_cases(device, dtype)
    # D = 0: the ExchangeELL form of level 1's remainder
    lvl1 = cases[1]
    assert lvl1[4]["route"] == "exchange" and lvl1[4]["recv"] is not None
    cases.append((None, g.NO_LANES, lvl1[2], 4,
                  dict(cols=lvl1[4]["cols"], vals=lvl1[4]["vals"],
                       recv=lvl1[4]["recv"], route="exchange")))
    routes = []
    for dv, lanes, x, ndev, kw in cases:
        routes.append((kw["route"], g.hyb_spmv_sharded_route(dv, lanes, x,
                                                             ndev, **kw)))
        g.reset_launch_counts()
        y = g.hyb_spmv_sharded(dv, lanes, x, ndev, **kw)
        assert g.launch_counts()["hyb_spmv_sharded"] == 1
        ref = g.hyb_spmv_sharded_plain(dv, lanes, x, ndev, **kw)
        torch.cuda.synchronize()
        assert torch.equal(y, ref), routes[-1]
    assert {r for r, _ in routes} == {"none", "exchange", "all_gather"}
    assert {k for _, k in routes} >= {"window", "scalar"}


def test_sharded_path_on_card_matches_cpu(device):
    """poisson2d(96) f32 on a 4-shard mesh: the same labels on the card as
    on the CPU, K4 and the sharded SpMV launched, and the two-level
    sharded solve in the same iteration count (±1)."""
    a = poisson2d(96)
    b = np.random.RandomState(0).rand(a.nrows)
    cfg = bench_config()
    kw = BENCH_HIERARCHY
    runs = {}
    for dev in (torch.device("cpu"), device):
        mesh = RowMesh(4, dev)
        g.reset_launch_counts()
        s = build_amg_setup_sharded(a.to_ell(dtype=torch.float32, device=dev),
                                    cfg, mesh)
        h = shard_hierarchy(build_hierarchy(s.matrices[0], s.level_labels,
                                            s.matrices[1:], **kw),
                            mesh, shard_levels=2)
        res = solve_hierarchy(h, b, method="bicgstab", tol=1e-6,
                              maxiter=200)
        runs[dev.type] = (s, res, g.launch_counts())
    (s_cpu, r_cpu, _), (s_gpu, r_gpu, n_gpu) = runs["cpu"], runs["cuda"]
    assert s_gpu.matrices[0].shard is not None
    for lg, lc in zip(s_gpu.level_labels, s_cpu.level_labels):
        assert torch.equal(lg.cpu(), lc)
    assert all(v > 0 for v in n_gpu.values())
    # every sharded-level SpMV is one launch, after one halo fill
    assert n_gpu["hyb_spmv_sharded"] > 0
    assert n_gpu["halo_fill"] >= n_gpu["take_sharded"]
    assert r_gpu.status == 0 and r_gpu.relres < 1e-6
    assert abs(r_gpu.iterations - r_cpu.iterations) <= 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_main_path_on_card_matches_cpu(device, dtype):
    """poisson2d(96): the same levels and labels on the card as on the
    CPU, K1-K3 launched (K4 serves only the sharded path), and the same
    iteration count (±1)."""
    a = poisson2d(96)
    b = np.random.RandomState(0).rand(a.nrows)
    cfg = bench_config()
    kw = BENCH_HIERARCHY
    runs = {}
    for dev in (torch.device("cpu"), device):
        g.reset_launch_counts()
        s = build_amg_setup(a.to_ell(dtype=dtype, device=dev), cfg)
        h = build_hierarchy(s.matrices[0], s.level_labels, s.matrices[1:],
                            **kw)
        res = solve_hierarchy(h, b, method="bicgstab", tol=1e-6,
                              maxiter=200)
        runs[dev.type] = (s, res, g.launch_counts())
    (s_cpu, r_cpu, n_cpu), (s_gpu, r_gpu, n_gpu) = runs["cpu"], runs["cuda"]
    assert [m.nrows for m in s_gpu.matrices] == [m.nrows
                                                 for m in s_cpu.matrices]
    for lg, lc in zip(s_gpu.level_labels, s_cpu.level_labels):
        assert torch.equal(lg.cpu(), lc)
    assert all(v == 0 for v in n_cpu.values())
    for name in ("take_sharded", "halo_fill", "hyb_spmv_sharded"):
        assert n_gpu.pop(name) == 0
    assert all(v > 0 for v in n_gpu.values())
    # per pass: one partner fetch, one member fetch per member set
    assert n_gpu["take_rows_many"] == 2 * n_gpu["take_rows"]
    assert r_gpu.status == 0 and r_gpu.relres < 1e-6
    assert abs(r_gpu.iterations - r_cpu.iterations) <= 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_take_rows_many_galerkin_four_sources(device, dtype):
    """K3 at the union Galerkin's member fetch: relabelled columns
    (int32), values, row lengths (int32) and the transposed-value field,
    in one launch, bitwise its plain version on both routes."""
    rs = np.random.RandomState(41)
    nsrc, k = 20480, 7
    sources = [words(rs, k * nsrc, torch.int32, device).view(k, nsrc),
               words(rs, k * nsrc, dtype, device).view(k, nsrc),
               words(rs, nsrc, torch.int32, device).view(1, nsrc),
               words(rs, k * nsrc, dtype, device).view(k, nsrc)]
    flat = torch.from_numpy(rs.randint(-1, nsrc, 6145).astype(np.int32)
                            ).to(device)
    g.reset_launch_counts()
    for idx, route in ((flat[:6144], "vector"), (flat[1:], "scalar")):
        assert g.take_rows_route(idx, sources) == route
        for out, ref in zip(g.take_rows_many(idx, sources),
                            g.take_rows_many_plain(idx, sources)):
            assert out.dtype == ref.dtype and torch.equal(out, ref)
    torch.cuda.synchronize()
    assert g.launch_counts()["take_rows_many"] == 2


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_lookup_route_on_card_matches_cpu(device, dtype):
    """The transposed-pattern lookup on csky3d(12) packed without the
    field: its K2 calls (a 1-D source of 4 or 8 bytes at the (K, n)
    column index) bitwise their plain version, 2K + 1 launches, and the
    values, pair mask and field transpose bitwise the CPU's."""
    a = csky3d(12)
    cpu = a.to_ell(dtype=dtype, device="cpu")
    gpu = a.to_ell(dtype=dtype, device=device)
    for src in (gpu.cols[3], gpu.vals[2], gpu.rownnz):
        assert torch.equal(g.take(gpu.cols, src.contiguous()),
                           g.take_plain(gpu.cols, src))
    g.reset_launch_counts()
    vt, hp = ops.transposed_slot_values(gpu, with_pairs=True)
    torch.cuda.synchronize()
    assert g.launch_counts()["take"] == 2 * gpu.k + 1
    vt_c, hp_c = ops.transposed_slot_values(cpu, with_pairs=True)
    assert torch.equal(vt.cpu(), vt_c) and torch.equal(hp.cpu(), hp_c)
    assert torch.equal(ops.pair_exists(gpu).cpu(), hp_c)
    field = torch.from_numpy(np.random.RandomState(2).rand(cpu.k, cpu.npad)
                             ).to(dtype)
    for mine, theirs in zip(ops.transpose_slot_field(gpu, field.to(device)),
                            ops.transpose_slot_field(cpu, field)):
        assert torch.equal(mine.cpu(), theirs)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_nonsym_path_on_card_matches_cpu(device, dtype):
    """csky3d(16) with the transposed-value field through the csky
    configuration: the same levels, labels and coarse fields on the card
    as on the CPU, every member fetch one four-source K3 launch, and the
    refinement to 1e-8 in the same outer sweeps."""
    a = csky3d(16)
    b = np.random.RandomState(0).rand(a.nrows)
    runs = {}
    for dev in (torch.device("cpu"), device):
        g.reset_launch_counts()
        s = build_amg_setup(a.to_ell(dtype=dtype, device=dev,
                                     with_transpose=True), csky_config())
        h = build_hierarchy(s.matrices[0], s.level_labels, s.matrices[1:],
                            **BENCH_HIERARCHY)
        runs[dev.type] = (s, solve_refined(h, a, b, **CSKY_REFINE),
                          g.launch_counts())
    (s_cpu, r_cpu, _), (s_gpu, r_gpu, n_gpu) = runs["cpu"], runs["cuda"]
    assert [m.nrows for m in s_gpu.matrices] == [m.nrows
                                                 for m in s_cpu.matrices]
    for lg, lc in zip(s_gpu.level_labels, s_cpu.level_labels):
        assert torch.equal(lg.cpu(), lc)
    for mg, mc in zip(s_gpu.matrices, s_cpu.matrices):
        assert torch.equal(mg.vals_t.cpu(), mc.vals_t)
    passes = sum(len(r.passes) for r in s_gpu.rounds)
    assert n_gpu["take_rows_many"] == 2 * n_gpu["take_rows"] == 2 * passes
    assert n_gpu["hyb_spmv"] > 0 and n_gpu["take"] > 0
    _, relres, inner, outer = r_gpu
    assert relres < 1e-8 and outer == r_cpu[3]
    assert abs(inner - r_cpu[2]) <= 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_split_triangular_hyb_spmv(device, dtype):
    """gs2's triangular SpMVs on the card: on every level of poisson2d(96)
    each strictly lower and upper part is one ``hyb_spmv`` launch, to
    rtol 1e-6 (f32) / 1e-12 (f64) of the plain ``spmv_tri`` on the card,
    and ``gs2_apply`` launches sweeps · 2 · (1 + inner) of them."""
    from multigridsolver_tpu_torch.solve.smoothers import make_smoother
    from multigridsolver_tpu_torch.sparse.hybrid import spmv_tri
    rs = np.random.RandomState(23)
    s = build_amg_setup(poisson2d(96).to_ell(dtype=dtype, device=device),
                        bench_config())
    tol = 1e-6 if dtype == torch.float32 else 1e-12
    for m in s.matrices:
        h = hybrid_from_ell(m)
        sm = make_smoother(h, kind="gs2")
        x = torch.from_numpy(rs.rand(h.npad)).to(device, dtype)
        for part, lower in ((sm.lower, True), (sm.upper, False)):
            g.reset_launch_counts()
            y = ops.spmv(part, x)
            assert g.launch_counts()["hyb_spmv"] == 1
            torch.testing.assert_close(y, spmv_tri(h, x, lower), rtol=tol,
                                       atol=tol)
        g.reset_launch_counts()
        sm.apply(h, x, x)
        assert g.launch_counts()["hyb_spmv"] == 12
        assert g.launch_counts()["gather_spmv"] == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_ilu0_row_fetch_and_factor_on_card(device, dtype):
    """ilu0 on csky3d(16)'s first coarse level: the two-source row fetch
    (K3: the columns and upper values of row k = cols[s]) bitwise its
    plain version, one K3 launch per slot and sweep (the columns fetched
    with the first sweep only), and the factors to rtol 1e-6 / 1e-12 of
    the same factorisation on the CPU."""
    from multigridsolver_tpu_torch.solve.smoothers import ilu0_factor
    s = build_amg_setup(csky3d(16).to_ell(dtype=dtype, device=device,
                                          with_transpose=True),
                        csky_config())
    m = s.matrices[1]
    uw = torch.rand(m.cols.shape, dtype=dtype, device=device)
    for k in range(m.k):
        idx = m.cols[k].contiguous()
        for out, ref in zip(g.take_rows_many(idx, [m.cols, uw]),
                            g.take_rows_many_plain(idx, [m.cols, uw])):
            assert torch.equal(out, ref)
    g.reset_launch_counts()
    got = ilu0_factor(m, sweeps=3)
    n = g.launch_counts()
    assert (n["take_rows_many"], n["take_rows"]) == (m.k, 2 * m.k)
    cpu = dataclasses_to_cpu(m)
    tol = 1e-6 if dtype == torch.float32 else 1e-12
    for a, b in zip(got, ilu0_factor(cpu, sweeps=3)):
        torch.testing.assert_close(a.cpu(), b, rtol=tol, atol=tol)


def dataclasses_to_cpu(m):
    import dataclasses
    return dataclasses.replace(
        m, cols=m.cols.cpu(), vals=m.vals.cpu(), rownnz=m.rownnz.cpu(),
        vals_t=None if m.vals_t is None else m.vals_t.cpu())


def test_smoothers_and_two_level_on_card_match_cpu(device):
    """poisson2d(96) f32: gs2, ilu0 and jacobi K-cycles, Chebyshev(2)
    with FCG and GMRES, and ``two_level_from_p`` (gs2 additive) give the
    CPU's iteration counts (±1) on the card."""
    from multigridsolver_tpu_torch.setup.prolongation import (
        p_csr_from_labels)
    from multigridsolver_tpu_torch.solve.api import two_level_from_p
    a = poisson2d(96)
    b = np.random.RandomState(0).rand(a.nrows)
    runs = {}
    for dev in (torch.device("cpu"), device):
        s = build_amg_setup(a.to_ell(dtype=torch.float32, device=dev),
                            bench_config())
        its = []
        for kind, method in (("gs2", "bicgstab"), ("ilu0", "bicgstab"),
                             ("jacobi", "bicgstab"), ("chebyshev", "fcg"),
                             ("chebyshev", "gmres")):
            kw = dict(BENCH_HIERARCHY, smoother_kind=kind)
            h = build_hierarchy(s.matrices[0], s.level_labels,
                                s.matrices[1:], **kw)
            res = solve_hierarchy(h, b, method=method, tol=1e-6,
                                  maxiter=200)
            assert res.status == 0 and res.relres < 1e-6
            its.append(res.iterations)
        p = p_csr_from_labels(s.level_labels[0][: a.nrows].cpu().numpy(),
                              s.matrices[1].nrows)
        h = two_level_from_p(a, p, dtype=torch.float32, device=dev,
                             smoother_kind="gs2", combination="additive")
        res = solve_hierarchy(h, b, method="bicgstab", tol=1e-6,
                              maxiter=200)
        assert res.status == 0
        its.append(res.iterations)
        runs[dev.type] = its
    assert all(abs(c - d) <= 1 for c, d in zip(runs["cpu"], runs["cuda"]))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_sharded_smoother_state_and_wide_halo_match_plain(device, dtype):
    """The sharded SpMVs the smoothers add, one launch each, bitwise
    their plain version on the same inputs: gs2's halves on a one-sided
    halo and ilu0's L and U on the index-list exchange (poisson2d(96), two
    sharded levels of 4 shards), and a hybrid whose halo exceeds a shard
    (128 shards of 32 rows, lanes at ±64), its halo read from the whole
    x;
    then each kind's sharded K-cycle in the CPU's count (±1)."""
    from multigridsolver_tpu_torch.parallel.halo import (make_halo_op,
                                                         spmv_route)
    from multigridsolver_tpu_torch.parallel.sharded import shard_operator
    mesh = RowMesh(4, device)
    s = build_amg_setup(poisson2d(96).to_ell(dtype=dtype, device=device),
                        bench_config())
    rs = np.random.RandomState(43)
    ops_ = []
    for kind in ("gs2", "ilu0"):
        h = shard_hierarchy(build_hierarchy(
            s.matrices[0], s.level_labels, s.matrices[1:],
            **dict(BENCH_HIERARCHY, smoother_kind=kind)), mesh,
            shard_levels=2)
        for lvl in h.levels[:2]:
            sm = lvl.smoother
            ops_ += [sm.lower, sm.upper] if kind == "gs2" \
                else [sm.lmat, sm.umat]
    wide_mesh = RowMesh(128, device)
    hw = shard_operator(hybrid_from_ell(poisson2d(64).to_ell(
        dtype=dtype, device=device)), wide_mesh)
    wide = make_halo_op(hw, wide_mesh)
    assert spmv_route(wide) == "all_gather"
    ops_.append(wide)
    for op in ops_:
        x = torch.from_numpy(rs.rand(op.npad)).to(device, dtype)
        args, kw = op.kernel_args(x)
        g.reset_launch_counts()
        y = g.hyb_spmv_sharded(*args, **kw)
        assert g.launch_counts()["hyb_spmv_sharded"] == 1
        ref = g.hyb_spmv_sharded_plain(*args, **kw)
        torch.cuda.synchronize()
        assert torch.equal(y, ref), (type(op).__name__, spmv_route(op))
    yw = wide.spmv(x)
    tol = 1e-6 if dtype == torch.float32 else 1e-12
    torch.testing.assert_close(yw, ops.spmv(hw, x), rtol=tol, atol=tol)
    b = np.random.RandomState(0).rand(96 * 96)
    for kind in ("jacobi", "l1jacobi", "gs2", "ilu0"):
        its = []
        for dev in (torch.device("cpu"), device):
            sd = build_amg_setup(poisson2d(96).to_ell(dtype=dtype,
                                                      device=dev),
                                 bench_config())
            h = shard_hierarchy(build_hierarchy(
                sd.matrices[0], sd.level_labels, sd.matrices[1:],
                **dict(BENCH_HIERARCHY, smoother_kind=kind)),
                RowMesh(4, dev), shard_levels=2)
            res = solve_hierarchy(h, b, method="bicgstab", tol=1e-6,
                                  maxiter=200)
            assert res.status == 0 and res.relres < 1e-6
            its.append(res.iterations)
        assert abs(its[0] - its[1]) <= 1, (kind, its)


def graph_case(case, device):
    """The bench's K-cycle hierarchy (pre- and post-smoothing 1) in f32:
    poisson2d(1000), or csky3d(20) packed with its transposed field."""
    if case == "poisson1000":
        ell, cfg = poisson2d(1000).to_ell(dtype=torch.float32,
                                          device=device), bench_config()
    else:
        ell, cfg = csky3d(20).to_ell(dtype=torch.float32, device=device,
                                     with_transpose=True), csky_config()
    s = build_amg_setup(ell, cfg)
    return build_hierarchy(s.matrices[0], s.level_labels, s.matrices[1:],
                           **BENCH_HIERARCHY)


def traced_calls(hier, bs):
    """One precondition call per b under a tracer: the results and the
    counters."""
    tracer = timing.PhaseTimer(device=bs[0].device)
    with timing.tracing(tracer):
        out = [hier.precondition(b) for b in bs]
    return out, tracer.counters


@pytest.mark.parametrize("case", ["poisson1000", "csky3d20"])
def test_cycle_graph_replays_the_eager_cycle(device, case):
    """The first call runs eagerly, the second captures, the rest replay;
    each of the three graph results is bitwise the eager cycle on its b,
    and each is a tensor of its own."""
    h = graph_case(case, device)
    gen = torch.Generator(device=device).manual_seed(5)
    bs = [torch.rand(h.levels[0].a.npad, generator=gen, device=device)
          for _ in range(4)]
    out, counters = traced_calls(h, bs)
    assert counters == {"kcycle.eager": 1, "kcycle.capture": 1,
                        "kcycle.replay": len(bs) - 2}
    for b, z in zip(bs, out):
        assert torch.equal(z, _cycle(h, 0, b))
    ptrs = {z.untyped_storage().data_ptr() for z in out}
    ptrs.add(h._graph.x.untyped_storage().data_ptr())
    assert len(ptrs) == len(out) + 1


def test_cycle_graph_solve_matches_eager_solve(device):
    """BiCGStab preconditioned by the replayed cycle: x bitwise and the
    count equal to the solve preconditioned by the eager cycle."""
    h = graph_case("poisson1000", device)
    a = h.levels[0].a
    b = pad_vector(np.random.RandomState(6).rand(a.nrows), a.npad,
                   torch.float32, device)
    eager = krylov.bicgstab(h.matvec, b, lambda v: _cycle(h, 0, v),
                            tol=1e-6, maxiter=200)
    tracer = timing.PhaseTimer(device=device)
    with timing.tracing(tracer):
        graphed = krylov.bicgstab(h.matvec, b, h.precondition, tol=1e-6,
                                  maxiter=200)
    assert eager.status == graphed.status == 0
    assert graphed.iterations == eager.iterations
    assert torch.equal(graphed.x, eager.x)
    # two calls an iteration: the first eager, the second captures
    assert tracer.counters == {"kcycle.eager": 1, "kcycle.capture": 1,
                               "kcycle.replay": 2 * eager.iterations - 2,
                               "host_reads": eager.iterations + 1}


def test_cycle_graph_not_on_a_row_mesh(device):
    """A hierarchy sharded over a one-process row mesh runs every call
    eagerly on the card."""
    h = shard_hierarchy(graph_case("csky3d20", device), RowMesh(2, device))
    b = torch.rand(h.levels[0].a.npad, device=device)
    out, counters = traced_calls(h, [b, b, b])
    assert counters == {"kcycle.eager": 3}
    assert h._graph is None


def test_cycle_graph_capture_holds_off_the_collector(device, monkeypatch):
    """A dropped hierarchy in a reference cycle, with its graph captured,
    stays alive through another hierarchy's capture: were the cyclic
    collector to free its graph there (it runs at any allocation while
    it is enabled), that capture would be invalidated."""
    base = graph_case("csky3d20", device)
    b = torch.rand(base.levels[0].a.npad, device=device)
    old = dataclasses.replace(base)
    old.precondition = lambda v, call=old.precondition: call(v)
    old.precondition(b)
    old.precondition(b)
    assert old._graph.graph is not None
    del old
    cycle = hierarchy_mod._cycle

    def collecting_cycle(hier, idx, v):
        if gc.isenabled() and torch.cuda.is_current_stream_capturing():
            gc.collect()
        return cycle(hier, idx, v)

    monkeypatch.setattr(hierarchy_mod, "_cycle", collecting_cycle)
    try:
        h = dataclasses.replace(base)
        out, counters = traced_calls(h, [b, b, b])
    finally:
        gc.collect()
    assert counters == {"kcycle.eager": 1, "kcycle.capture": 1,
                        "kcycle.replay": 1}
    want = cycle(base, 0, b)
    assert all(torch.equal(z, want) for z in out)


def test_ilu0_cycle_graph_and_factor_events(device):
    """The ilu0 K-cycle (the benchmark's poisson2000ilu0 settings) at
    poisson2d(300): every call after the capture replays, bitwise the
    eager cycle; ``ilu0.factor`` spans with events give one positive
    device time a level, and the factors are bitwise those built with no
    tracer."""
    ell = poisson2d(300).to_ell(dtype=torch.float32, device=device)
    s = build_amg_setup(ell, bench_config())
    kw = dict(smoother_kind="ilu0", cycle="kcycle", kcycle_depth=3,
              pre_smooth=1, post_smooth=1, sweeps=2, inner_sweeps=2,
              factor_sweeps=5)
    plain = build_hierarchy(s.matrices[0], s.level_labels, s.matrices[1:],
                            **kw)
    tracer = timing.PhaseTimer(device=device, device_spans=("ilu0.factor",))
    with timing.tracing(tracer):
        h = build_hierarchy(s.matrices[0], s.level_labels, s.matrices[1:],
                            **kw)
    got = tracer.device_seconds("ilu0.factor")
    assert sorted(got) == list(range(len(h.levels)))
    assert all(t > 0 for t in got.values())
    for lt, lp in zip(h.levels, plain.levels):
        assert torch.equal(lt.smoother.lmat.vals, lp.smoother.lmat.vals)
        assert torch.equal(lt.smoother.udiag, lp.smoother.udiag)
    gen = torch.Generator(device=device).manual_seed(9)
    bs = [torch.rand(h.levels[0].a.npad, generator=gen, device=device)
          for _ in range(4)]
    out, counters = traced_calls(h, bs)
    assert counters["kcycle.replay"] == len(bs) - 2
    # the smoother's counter is seen on the eager and capturing calls only
    assert counters["ilu0.tri_spmv"] > 0
    for b, z in zip(bs, out):
        assert torch.equal(z, _cycle(h, 0, b))
