#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing a line:

1. device: requires CUDA and prints ``nvidia-smi``'s name and power limit;
2. build: compiles the gather kernels (``multigridsolver_tpu_torch/csrc``)
   with nvcc for sm_90a;
3. kernels: the floor of a launch (an empty kernel), then K1 without
   lanes (``gather_spmv``), K2 (take: 1-, 4- and 8-byte words, a bool
   field beside the int32 round trip it replaced), K3 (take rows: one
   source, and up to four in one launch beside the one-source launches
   they replaced) and K4 (sharded take: 1-, 4- and 8-byte words, a bool
   field beside the int32 round trip it replaced; its halo fill beside
   the list-indexed shifts it replaced) against their plain PyTorch
   versions on the card at the main path's shapes (K4 at the finest
   sharded level of poisson1000 on four shards), every route of K2, K3
   and K4 (vector, scalar tail, an index view at a 4-byte offset), with their
   device times (CUDA events, median of 20 calls, L2 evicted before
   each), the time of one PyTorch library call computing the same
   function, and the least time the card's memory rate allows; then K2
   and K3 again at the index arrays the main path itself passes them in
   poisson1000's first pass (``a.cols``, the proposals, the pairs, the
   aggregate leaders);
4. main path: poisson1000 (n = 10⁶) through ``to_ell`` →
   ``build_amg_setup`` → ``build_hierarchy`` → ``solve_hierarchy``
   (BiCGStab to 1e-6): in f32 with the kernels' launch counts (also by
   shape bucket) and a
   bitwise μ(i→j) == μ(j→i) check on every aggregated level, again in
   f32 for times without first-use costs, and in f64, each checked for
   status, relative residuals and iteration count, the f32 runs also for
   their level sizes;
5. hybrid SpMV: K1 with lanes (``hyb_spmv``) on every level of the f32
   and f64 hierarchies of step 4, bitwise against the route it replaced
   (the torch lane loop, then K1 without lanes) and against its plain
   version; on level 1 with its offsets spread past the shared-memory
   budget (the lanes then read x through ``__ldg``); timed at the shapes
   of levels 0 and 1 beside its plain version, the old route, the same
   operator through cuSPARSE (``torch.mv`` on CSR) and its bound, and
   with the x window turned off;
6. sharded path: the same f32 problem on a 4-shard row mesh on the card
   through ``build_amg_setup_sharded`` (finest-level gathers on the halo
   exchange and K4) → ``build_hierarchy`` → ``shard_hierarchy`` (the two
   finest levels sharded) → ``solve_hierarchy``: the route of each
   sharded level, labels bitwise equal to the unsharded run's on every
   level, the same iteration count, every kernel launched (bool fields
   through K4 as bytes; one halo fill and one ``hyb_spmv_sharded`` launch
   per sharded-level SpMV), and the phase times beside the unsharded ones;
7. sharded SpMV: ``hyb_spmv_sharded`` at the shapes of the sharded
   levels 0 (pure DIA) and 1 (48 lanes, remainder on the index-list
   exchange), bitwise against its plain version and the route it replaced
   (ring halos, torch lane loop, K1 per shard), timed beside them, the
   whole ``HaloOp.spmv``, cuSPARSE on the same operator and its bound.

The last two lines are a JSON object with the per-kernel results (for
``hyb_spmv`` and ``hyb_spmv_sharded`` also the old route's time, for
``hyb_spmv`` the ``__ldg`` lanes', for ``hyb_spmv_sharded`` the whole
``HaloOp.spmv``'s, for ``take_rows_many`` the time of one ``take_rows``
launch per source, for K2-K4 the scalar route's) and
the launch floor, and
``{"ok": true, "device": {...}}``.  A kernel's ``launches`` there is the
sum of its launches in the first unsharded f32 run and in the sharded
run, each counted from 0; ``launches_by_path`` gives the two apart.  Any failure exits non-zero before the
result lines.  There is no CPU fallback.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
PKG = "multigridsolver_tpu_torch"

# level sizes of the JAX package's own run of this configuration (CPU,
# f32, the plan-free path): the port must reproduce them exactly
EXPECT_LEVELS = [1000000, 294006, 86479, 25624, 7535, 2190, 624, 169]
ITERS_RANGE = (7, 9)
# the card's sleep ahead of the timed calls: at least about 10 ms at the
# H100's clocks, and twice what the host takes to enqueue them, counted
# at the SM clock's maximum (about 2 GHz)
SLEEP_CYCLES = 20_000_000
SM_CYCLES_PER_S = 2e9
L2_FLUSH_BYTES = 100 << 20
# the H100 SXM's published peaks (memory rate; float32 outside the tensor
# cores), against which each kernel's least possible time is computed
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
SOURCE = f"{PKG}/csrc/gather.cu"
# hyb_spmv also replaces the XLA-fused DIA pass around the TPU kernel
# (multigridsolver_tpu/sparse/hybrid.py:223-242)
REPLACES = {
    "gather_spmv": "multigridsolver_tpu/ops/gather_pallas.py:255",
    "hyb_spmv": "multigridsolver_tpu/ops/gather_pallas.py:255",
    "take": "multigridsolver_tpu/ops/gather_pallas.py:300",
    "take_rows": "multigridsolver_tpu/ops/gather_pallas.py:359",
    "take_rows_many": "multigridsolver_tpu/ops/gather_pallas.py:359",
    "take_sharded": "multigridsolver_tpu/ops/gather_pallas.py:368",
    # the two ppermutes of windowed_take_sharded: K4's halo exchange
    "halo_fill": "multigridsolver_tpu/ops/gather_pallas.py:406",
    # an XLA body in the JAX package (no Pallas kernel there)
    "hyb_spmv_sharded": "multigridsolver_tpu/parallel/halo.py:135",
}


class SmokeFailure(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, calls: int = 20) -> float:
    """Device time of one call of ``fn`` in ms: the median over ``calls``
    calls of CUDA events around each call (after a warm-up).  Before each
    call a read of twice the 50 MB L2 evicts its inputs, as a solve that
    walks the levels finds them (a read, so the call pays for no dirty
    lines written back).  A sleep kernel queued ahead holds the
    card while the host enqueues the calls, so the host's launch costs
    (Python checks, ctypes, the allocator) stay out of the reading; it
    lasts twice the host's enqueue time of the calls, which for a route of
    a hundred small launches is far longer than for one kernel."""
    import torch
    flush = torch.zeros(L2_FLUSH_BYTES // 4, dtype=torch.float32,
                        device="cuda")
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    flush.sum()
    fn()
    enqueue_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(calls)]
    torch.cuda._sleep(max(SLEEP_CYCLES,
                          int(2 * calls * enqueue_s * SM_CYCLES_PER_S)))
    for start, end in events:
        flush.sum()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def bound_ms(nbytes: int, flops: int = 0) -> tuple[float, str]:
    """The least time the card could take: the larger of the bytes over
    the memory rate and the float32 operations over the peak rate."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def record(res, name, shape_tag, err, fn, plain, library, nbytes, flops=0,
           extra=None):
    """Time ``fn`` beside its plain version, its library yardstick and the
    ``extra`` routes ({key: callable}), log the line, and keep the first
    shape's numbers of each kernel for the JSON line."""
    ms, plain_ms = time_ms(fn), time_ms(plain)
    library_ms = time_ms(library) if library is not None else None
    more = {k: time_ms(f) for k, f in (extra or {}).items()}
    b_ms, b_by = bound_ms(nbytes, flops)
    r = res.setdefault(name, {"max_abs_err": 0.0})
    r["max_abs_err"] = max(r["max_abs_err"], err)
    if "ms" not in r:
        r.update(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                 bound_ms=b_ms, bound_by=b_by, **more)
    log(f"kernel {name} {shape_tag}: max_abs_err={err!r} ms={ms!r} "
        f"plain_ms={plain_ms!r} library_ms={library_ms!r} "
        + "".join(f"{k}={v!r} " for k, v in more.items())
        + f"bound_ms={b_ms!r} ({b_by}, {nbytes} bytes)")


def touched(idx) -> int:
    """Distinct source words an index array reads (its data decides how
    many a gather must move)."""
    import torch
    return int(torch.unique(idx.reshape(-1)).numel())


def banded_ell(rs, n: int, k: int, band: int, dtype, device):
    """Random banded slot-major ELL arrays (invalid slots: col 0, val 0)."""
    import numpy as np
    import torch
    npad = (n + 1023) // 1024 * 1024
    rows = np.arange(npad)
    cols = np.clip(rows[None, :] + rs.randint(-band, band + 1, (k, npad)),
                   0, n - 1).astype(np.int32)
    vals = rs.rand(k, npad)
    rownnz = rs.randint(1, k + 1, npad).astype(np.int32)
    rownnz[n:] = 0
    valid = np.arange(k)[:, None] < rownnz[None, :]
    cols[~valid] = 0
    vals[~valid] = 0.0
    return (torch.from_numpy(cols).to(device),
            torch.from_numpy(vals).to(device=device, dtype=dtype),
            torch.from_numpy(valid).to(device))


def csr_of(cols, vals, valid, ncols: int):
    """The same matrix as a ``torch.sparse_csr_tensor`` (columns sorted
    within each row), for the cuSPARSE SpMV yardstick."""
    import torch
    big = torch.iinfo(torch.int64).max
    key = torch.where(valid.T, cols.T.long(), big)
    key, order = torch.sort(key, dim=1)
    keep = key != big
    v = torch.gather(vals.T, 1, order)[keep]
    counts = keep.sum(1)
    crow = torch.zeros(counts.shape[0] + 1, dtype=torch.int64,
                       device=cols.device)
    crow[1:] = torch.cumsum(counts, 0)
    return torch.sparse_csr_tensor(crow, key[keep], v,
                                   size=(cols.shape[1], ncols))


def mu_mismatches(a, agg) -> int:
    """Slots (i→j) allowed for pairing whose μ differs bitwise from the μ
    of the reverse slot (j→i).  The handshake matching needs none (the
    JAX package's ``bench.py:154-165`` makes the same check)."""
    import torch
    from multigridsolver_tpu_torch.setup.strength import compute_strength
    st = compute_strength(a, agg.ktg, True, checkdd=agg.checkdd,
                          trspos=agg.trspos, fracnegrcsum=agg.fracnegrcsum)
    cols = a.cols.long()
    slot = torch.arange(a.k, device=a.device)[:, None, None]
    # back[s, k, i] = cols[s, j] for j = cols[k, i]: the slots of row j
    back = cols[:, cols]
    hit = (back == a.row_iota().long()[None]) \
        & (slot < a.rownnz.long()[cols][None])
    mu_t = st.mu[hit.int().argmax(0), cols]
    return int((hit.any(0) & st.allowed & (st.mu != mu_t)).sum())


def timed(fn):
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def phase_device():
    import torch
    check(torch.cuda.is_available(), "CUDA is not available")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    line = smi.stdout.strip().splitlines()[0]
    log(line)
    kind = torch.cuda.get_device_name(0)
    log(f"device: {kind} count={torch.cuda.device_count()} "
        f"torch={torch.__version__} cuda={torch.version.cuda}")
    return kind


def phase_build():
    from multigridsolver_tpu_torch.ops import gather
    t0 = time.perf_counter()
    path = gather.build(verbose=True)
    gather.load_library()
    log(f"build: {os.path.relpath(path, HERE)} in "
        f"{time.perf_counter() - t0:.3f} s")


def phase_kernels(device, problem) -> tuple[dict, float]:
    """Each kernel against its plain version at main-path shapes, timed
    beside its plain version, its library yardstick and its bound (the
    first shape of each kernel is the one reported in the JSON line).
    Returns those results and the launch floor (ms)."""
    import numpy as np
    import torch
    from multigridsolver_tpu_torch.ops import gather as g
    from multigridsolver_tpu_torch.parallel import RowMesh, shard_ell_halo
    from multigridsolver_tpu_torch.utils.config import BENCH_NDEV as NDEV
    rs = np.random.RandomState(0)
    res = {}
    # the floor under every time below: an empty kernel, timed the same way
    floor_ms = time_ms(lambda: g.empty_launch(device))
    log(f"launch floor: an empty kernel reads {floor_ms!r} ms by time_ms")

    # K1 without lanes: finest-level ELL shape, coarse HYB remainder
    # shape, f64 variant
    for k, n, dtype, rtol in [(5, 1000000, torch.float32, 1e-6),
                              (9, 294006, torch.float32, 1e-6),
                              (9, 294006, torch.float64, 1e-12)]:
        cols, vals, valid = banded_ell(rs, n, k, 1000, dtype, device)
        x = torch.from_numpy(rs.rand(cols.shape[1])).to(device=device,
                                                         dtype=dtype)
        y = g.gather_spmv(cols, vals, x)
        ref = g.gather_spmv_plain(cols, vals, x)
        torch.cuda.synchronize()
        atol = 1e-6 if dtype == torch.float32 else 1e-12
        check(torch.allclose(y, ref, rtol=rtol, atol=atol),
              f"K1 {k}x{cols.shape[1]} {dtype} disagrees with its plain "
              "version")
        err = float((y.double() - ref.double()).abs().max())
        csr = csr_of(cols, vals, valid, x.shape[0])
        w = x.element_size()
        nbytes = cols.numel() * (4 + w) + (touched(cols) + y.numel()) * w
        record(res, "gather_spmv", f"K={k} npad={cols.shape[1]} {dtype}",
               err,
               lambda: g.gather_spmv(cols, vals, x),
               lambda: g.gather_spmv_plain(cols, vals, x),
               lambda: torch.mv(csr, x), nbytes,
               2 * int(valid.sum()) if dtype == torch.float32 else 0)

    # K2: slot fields (K, npad) and 1-D index vectors with -1 sentinels
    npad = 1000448
    cols, _, _ = banded_ell(rs, 1000000, 5, 1000, torch.float32, device)
    idx1 = torch.from_numpy(np.where(rs.rand(npad) < 0.1, -1,
                                     rs.randint(0, 1000000, npad))
                            .astype(np.int32)).to(device)
    xf = torch.from_numpy(rs.rand(npad).astype(np.float32)).to(device)
    xi = torch.from_numpy(rs.randint(-2**31, 2**31 - 1, npad,
                                     dtype=np.int64).astype(np.int32)
                          ).to(device)
    xd = xf.double()
    xb = torch.from_numpy(rs.rand(npad) < 0.5).to(device)
    for idx, x in [(cols, xf), (cols, xi), (idx1, xf), (idx1, xi),
                   (idx1, xd), (cols, xb)]:
        record_take(res, idx, x, "")
    # every route bitwise at these shapes: an n % 4 tail, and index views
    # at a 4-byte offset (scalar route), for each word size
    for x in (xf, xd, xb):
        for idx, route in ((idx1[:npad - 1], "vector"),
                           (idx1[1:], "scalar")):
            check(g.take_route(idx, x) == route,
                  f"K2 n={idx.numel()} took route {g.take_route(idx, x)}")
            check_bits(g.take(idx, x), g.take_plain(idx, x),
                       f"K2 {route} n={idx.numel()} x {x.dtype}")
    log(f"kernel take routes: vector with a tail of {(npad - 1) % 4} and "
        f"scalar (idx at a 4-byte offset) bitwise for float32, float64, "
        "bool")
    record_take(res, idx1[1:], xf, " (idx at a 4-byte offset)")

    # K3: S = 9 relabelled slot rows fetched at coarse member indices
    nsrc, nc_pad = 294912, 86016
    idxm = torch.from_numpy(np.where(rs.rand(nc_pad) < 0.05, -1,
                                     rs.randint(0, 294006, nc_pad))
                            .astype(np.int32)).to(device)
    xs_f = torch.from_numpy(rs.rand(9, nsrc).astype(np.float32)).to(device)
    xs_i = torch.from_numpy(rs.randint(-1, 86479, (9, nsrc))
                            .astype(np.int32)).to(device)
    for xs in [xs_f, xs_i, xs_f.double()]:
        record_take_rows(res, idxm, [xs], "")
    # the Galerkin member fetch: relabelled columns, values, row lengths
    nnz = torch.from_numpy(rs.randint(0, 10, (1, nsrc)).astype(np.int32)
                           ).to(device)
    for vals in (xs_f, xs_f.double()):
        record_take_rows(res, idxm, [xs_i, vals, nnz], "")
    # every route bitwise: an n % 4 tail and an index view at a 4-byte
    # offset take the scalar route, for one to four mixed sources
    for idx in (idxm[:nc_pad - 1], idxm[1:]):
        for srcs in ([xs_f.double()], [xs_i, xs_f.double()],
                     [xs_i, xs_f, nnz], [xs_i, xs_f.double(), nnz, xs_f]):
            check(g.take_rows_route(idx, srcs) == "scalar",
                  f"K3 n={idx.numel()} took the vector route")
            for out, ref in zip(g.take_rows_many(idx, srcs),
                                g.take_rows_many_plain(idx, srcs)):
                check_bits(out, ref, f"K3 scalar n={idx.numel()} "
                           f"{len(srcs)} sources")
    log("kernel take_rows routes: scalar (tail of 3; idx at a 4-byte "
        "offset) bitwise for 1-4 mixed sources")
    record_take_rows(res, idxm[1:], [xs_i, xs_f, nnz],
                     " (idx at a 4-byte offset)")

    # K4: the finest sharded level of poisson1000 on four shards, its
    # stored columns and a 1-D index with -1 sentinels, words of 4, 1 and
    # 8 bytes, each on the vector and the scalar route; the halo fill
    a = shard_ell_halo(problem.to_ell(dtype=torch.float32, device=device),
                       RowMesh(NDEV, device))
    check(a is not None, "poisson1000 does not shard with a single-hop halo")
    mesh, npr, h = a.shard
    log(f"kernel take_sharded shape: K={a.k} ndev={NDEV} npr={npr} h={h}")
    n = a.npad
    idx1 = torch.where(torch.from_numpy(rs.rand(n) < 0.1).to(device), -1,
                       a.cols[0]).to(torch.int32).contiguous()
    xf = torch.from_numpy(rs.rand(n).astype(np.float32)).to(device)
    xi = torch.from_numpy(rs.randint(-2**31, 2**31 - 1, n, dtype=np.int64)
                          .astype(np.int32)).to(device)
    xb = torch.from_numpy(rs.rand(n) < 0.5).to(device)
    for idx, x in [(a.cols, xf), (a.cols, xb), (a.cols, xf.double()),
                   (idx1, xi), (idx1, xb), (idx1, xf.double())]:
        record_take_sharded(res, mesh, idx, x, npr, h)
    record_halo_fill(res, mesh, xf, npr, h)
    phase_main_shapes(device, problem, res)
    return res, floor_ms


def record_take_sharded(res, mesh, idx, x, npr: int, h: int) -> None:
    """K4 on ``idx``/``x`` bitwise against its plain version on both
    routes, timed beside its plain version, its library yardstick (the
    halo concatenation, then one ``index_select`` at indices rebased into
    it), its scalar route and, for a bool field, the int32 round trip it
    replaced."""
    import torch
    from multigridsolver_tpu_torch.ops import gather as g
    ndev, n = mesh.ndev, idx.shape[-1]
    halo = mesh.boundary_halo(x, h)
    check_bits(halo, g.halo_fill_plain(x, ndev, h), f"halo_fill {x.dtype}")
    route = g.take_sharded_route(idx, x, halo, npr, h)
    check(route == "vector", f"K4 idx {tuple(idx.shape)} took route {route}")
    out = g.take_sharded(idx, x, halo, npr, h)
    check_bits(out, g.take_sharded_plain(idx, x, halo, npr, h),
               f"K4 idx {tuple(idx.shape)} x {x.dtype}")
    iu = unaligned(idx)
    check(g.take_sharded_route(iu, x, halo, npr, h) == "scalar",
          "K4 on an unaligned index did not take the scalar route")
    check_bits(g.take_sharded(iu, x, halo, npr, h), out,
               "K4's scalar and vector routes")
    extra = {"scalar_ms": lambda: g.take_sharded(iu, x, halo, npr, h)}
    if x.dtype == torch.bool:
        def old():
            xw = x.to(torch.int32)
            return g.take_sharded(idx, xw, mesh.boundary_halo(xw, h), npr,
                                  h) != 0
        check(torch.equal(old(), out),
              "K4 on a bool field differs from the int32 round trip")
        extra["old_route_ms"] = old
    ext = npr + 2 * h
    rows = torch.arange(n, device=x.device) // npr
    c = (idx.long() - (rows * npr - h)).clamp(0, ext - 1)
    ext_idx = (rows * ext + c).reshape(-1)
    xs = x.view(ndev, npr)

    def library():
        return torch.cat([halo[:, 0], xs, halo[:, 1]], 1).view(-1) \
            .index_select(0, ext_idx)
    check(torch.equal(library().view(idx.shape), out),
          "K4's library yardstick computes another function")
    w = x.element_size()
    record(res, "take_sharded", f"idx={tuple(idx.shape)} x={x.dtype} "
           f"npr={npr} h={h} route={route}", 0.0,
           lambda: g.take_sharded(idx, x, halo, npr, h),
           lambda: g.take_sharded_plain(idx, x, halo, npr, h), library,
           idx.numel() * (4 + w) + touched(ext_idx) * w, extra=extra)


def record_halo_fill(res, mesh, x, npr: int, h: int) -> None:
    """The halo fill bitwise against its plain version, timed beside the
    route it replaced (two non-cyclic shifts by list indexing, a stack);
    no one library call fills it."""
    import torch
    from multigridsolver_tpu_torch.ops import gather as g
    ndev = mesh.ndev
    xs = x.view(ndev, npr)

    def old():
        def shift(send, step):
            pairs = [(s, s + step) for s in range(ndev)
                     if 0 <= s + step < ndev]
            recv = torch.zeros_like(send)
            src, dst = zip(*pairs)
            recv[list(dst)] = send[list(src)]
            return recv
        return torch.stack([shift(xs[:, npr - h:], 1), shift(xs[:, :h], -1)],
                           1).contiguous()
    halo = g.halo_fill(x, ndev, h)
    check_bits(halo, g.halo_fill_plain(x, ndev, h), "halo_fill")
    check_bits(halo, old(), "halo_fill against the route it replaced")
    w = x.element_size()
    record(res, "halo_fill", f"ndev={ndev} npr={npr} h={h} x={x.dtype}",
           0.0, lambda: g.halo_fill(x, ndev, h),
           lambda: g.halo_fill_plain(x, ndev, h), None,
           (2 * (ndev - 1) + 2 * ndev) * h * w,
           extra={"old_route_ms": old})




def unaligned(idx):
    """A copy of ``idx`` 4 bytes off 16-byte alignment: K2 and K3 take
    their scalar route (one word per thread, the old kernels' layout) on
    it, at the same shape and indices."""
    import torch
    buf = torch.empty(idx.numel() + 1, dtype=idx.dtype, device=idx.device)
    out = buf[1:].view(idx.shape)
    out.copy_(idx)
    return out


def check_bits(out, ref, what: str) -> None:
    """``out`` equals ``ref`` bit for bit (dtype, shape and bytes)."""
    import torch
    torch.cuda.synchronize()
    check(out.dtype == ref.dtype and out.shape == ref.shape
          and torch.equal(out.reshape(-1).view(torch.uint8),
                          ref.reshape(-1).view(torch.uint8)),
          f"{what} is not bitwise equal to its plain version")


def record_take(res, idx, x, tag: str) -> None:
    """K2 on ``idx``/``x`` bitwise against its plain version, timed; a
    bool field also beside the int32 round trip K2 replaced."""
    import torch
    from multigridsolver_tpu_torch.ops import gather as g
    check_bits(g.take(idx, x), g.take_plain(idx, x),
               f"K2 idx {tuple(idx.shape)} x {x.dtype}")
    extra = {}
    if g.take_route(idx, x) == "vector":
        iu = unaligned(idx)
        check(g.take_route(iu, x) == "scalar", "K2 on an unaligned index "
              "did not take the scalar route")
        check_bits(g.take(iu, x), g.take(idx, x),
                   "K2's scalar and vector routes")
        extra["scalar_ms"] = lambda: g.take(iu, x)
    if x.dtype == torch.bool:
        def old():
            return g.take(idx, x.to(torch.int32)) != 0
        check(torch.equal(old(), g.take(idx, x)),
              "K2 on a bool field differs from the int32 round trip")
        extra["old_route_ms"] = old
    idx64 = idx.long().clamp(0, x.shape[0] - 1).reshape(-1)
    w = x.element_size()
    record(res, "take", f"idx={tuple(idx.shape)} x={x.dtype} "
           f"route={g.take_route(idx, x)}{tag}", 0.0,
           lambda: g.take(idx, x), lambda: g.take_plain(idx, x),
           lambda: torch.index_select(x, 0, idx64),
           idx.numel() * (4 + w) + touched(idx64) * w, extra=extra)


def record_take_rows(res, idx, srcs, tag: str) -> None:
    """K3 on ``idx`` and the sources ``srcs`` bitwise against its plain
    version, timed; several sources (``take_rows_many``) also beside one
    ``take_rows`` launch per source, the route they replaced."""
    import torch
    from multigridsolver_tpu_torch.ops import gather as g
    n = idx.numel()
    idx64 = idx.long().clamp(0, srcs[0].shape[1] - 1)
    nbytes = n * 4 + sum(xs.shape[0] * (n + touched(idx64))
                         * xs.element_size() for xs in srcs)
    shape = (f"n={n} nsrc={srcs[0].shape[1]} sources="
             + "+".join(f"{xs.shape[0]}x{str(xs.dtype)[6:]}" for xs in srcs)
             + f" route={g.take_rows_route(idx, srcs)}{tag}")
    extra = {}
    if g.take_rows_route(idx, srcs) == "vector":
        iu = unaligned(idx)
        check(g.take_rows_route(iu, srcs) == "scalar", "K3 on an unaligned "
              "index did not take the scalar route")
        for out, ref in zip(g.take_rows_many(iu, srcs),
                            g.take_rows_many(idx, srcs)):
            check_bits(out, ref, "K3's scalar and vector routes")
        extra["scalar_ms"] = lambda: g.take_rows_many(iu, srcs)
    if len(srcs) == 1:
        xs = srcs[0]
        check_bits(g.take_rows(idx, xs), g.take_rows_plain(idx, xs),
                   f"K3 {shape}")
        record(res, "take_rows", shape, 0.0, lambda: g.take_rows(idx, xs),
               lambda: g.take_rows_plain(idx, xs),
               lambda: xs.index_select(1, idx64), nbytes, extra=extra)
        return

    def old():
        return [g.take_rows(idx, xs) for xs in srcs]
    for out, ref, prev in zip(g.take_rows_many(idx, srcs),
                              g.take_rows_many_plain(idx, srcs), old()):
        check_bits(out, ref, f"K3 {shape}")
        check_bits(out, prev, f"K3 {shape} against one launch per source")
    # no one library call gathers sources of several dtypes
    extra["old_route_ms"] = old
    record(res, "take_rows_many", shape, 0.0,
           lambda: g.take_rows_many(idx, srcs),
           lambda: g.take_rows_many_plain(idx, srcs), None, nbytes,
           extra=extra)


def phase_main_shapes(device, problem, res) -> None:
    """K2 and K3 at the index arrays poisson1000 f32's first pass gives
    them (level 0): the stored columns (strength's neighbour fields, the
    matching's bool availability), the first round's proposals, the pairs
    (labelling), and the aggregates' leaders and partners (Galerkin)."""
    import torch
    from multigridsolver_tpu_torch.ops import gather as g
    from multigridsolver_tpu_torch.setup import matching
    from multigridsolver_tpu_torch.setup.galerkin import pair_members
    from multigridsolver_tpu_torch.setup.strength import compute_strength
    from multigridsolver_tpu_torch.sparse.ops import (extract_diag,
                                                      take_neighbor)
    from multigridsolver_tpu_torch.utils.config import bench_config
    agg = bench_config().aggregation
    a = problem.to_ell(dtype=torch.float32, device=device)
    st = compute_strength(a, agg.ktg, True, checkdd=agg.checkdd,
                          trspos=agg.trspos, fracnegrcsum=agg.fracnegrcsum)
    avail = ~st.excluded
    prop = matching._best_neighbor(a, st.mu, st.allowed, avail,
                                   matching._edge_hash(a))
    paired = matching.mutual_match(a, st, agg.max_matching_rounds)
    labels, nc = matching.labels_from_pairs(paired, st.excluded, a)
    nc_pad = (nc + 1023) // 1024 * 1024
    _, leader, partner, _ = pair_members(paired, labels, nc_pad)
    lc_fine = take_neighbor(a, labels)
    log(f"main-path shapes (the bench problem in f32, level 0, pass 1): "
        f"n={a.nrows} K={a.k} npad={a.npad} nc={nc} nc_pad={nc_pad}")
    record_take(res, a.cols, extract_diag(a), " main a.cols")
    record_take(res, a.cols, avail, " main a.cols (available)")
    record_take(res, prop.clamp_min(0), prop, " main prop")
    agg_of_leader = torch.cumsum(paired >= 0, 0, dtype=torch.int32)
    record_take(res, paired.clamp_min(0), agg_of_leader, " main paired")
    record_take_rows(res, leader, [paired[None, :]],
                     " main safe_leader (partner fetch)")
    for members, tag in ((leader, "safe_leader"), (partner, "partner_of")):
        record_take_rows(res, members, [lc_fine, a.vals, a.rownnz[None, :]],
                         f" main {tag}")


def phase_main_path(device, a) -> dict:
    import numpy as np
    import torch
    from multigridsolver_tpu_torch.ops import gather as g
    from multigridsolver_tpu_torch.setup.aggregation import build_amg_setup
    from multigridsolver_tpu_torch.solve.api import solve_hierarchy
    from multigridsolver_tpu_torch.solve.hierarchy import build_hierarchy
    from multigridsolver_tpu_torch.utils.config import (BENCH_HIERARCHY,
                                                        bench_config)
    a_sp = a.to_scipy()
    b = np.random.RandomState(0).rand(a.nrows)
    cfg = bench_config()

    def run(dtype, expect_levels):
        ell, t_ell = timed(lambda: a.to_ell(dtype=dtype, device=device))
        setup, t_setup = timed(lambda: build_amg_setup(ell, cfg))
        hier, t_hier = timed(lambda: build_hierarchy(
            setup.matrices[0], setup.level_labels, setup.matrices[1:],
            **BENCH_HIERARCHY))
        res, t_solve = timed(lambda: solve_hierarchy(
            hier, b, method="bicgstab", tol=1e-6, maxiter=200))
        tag = str(dtype).replace("torch.", "")
        times = dict(to_ell=t_ell, setup=t_setup, hierarchy=t_hier,
                     solve=t_solve)
        true_res, floor = check_solution(
            f"main path {tag}", a_sp, b, setup, res, times, dtype,
            expect_levels)
        return dict(true_res=true_res, floor=floor, setup=setup, hier=hier,
                    iterations=res.iterations, times=times, b=b, a_sp=a_sp)

    g.reset_launch_counts()
    with g.launch_shapes() as shapes:
        first = run(torch.float32, EXPECT_LEVELS)
    counts = g.launch_counts()
    log(f"main path launches: {json.dumps(counts)}")
    for name in ("gather_spmv", "hyb_spmv", "take", "take_rows",
                 "take_rows_many"):
        check(counts[name] > 0,
              f"kernel {name} was not launched by the main path")
    log_shapes(shapes)
    # K3: per pass one partner fetch (take_rows) and one member fetch per
    # member set (take_rows_many, three sources each)
    passes = sum(len(r.passes) for r in first["setup"].rounds)
    check(counts["take_rows"] == passes
          and counts["take_rows_many"] == 2 * passes,
          f"K3 launched {counts['take_rows']} + {counts['take_rows_many']} "
          f"times over {passes} passes, not 1 + 2 per pass")
    bool_takes = sum(c for (name, _, _, w), c in shapes.items()
                     if name == "take" and w == 1)
    check(bool_takes > 0, "no bool field went through K2 as bytes")
    log(f"main path: {passes} passes, K3 launches {counts['take_rows']} + "
        f"{counts['take_rows_many']} = "
        f"{counts['take_rows'] + counts['take_rows_many']}; "
        f"bool fields through K2 as bytes: {bool_takes}")
    mism = [mu_mismatches(m, cfg.aggregation)
            for m in first["setup"].matrices[:-1]]
    log(f"main path float32 mu bitwise symmetry, mismatches per level: "
        f"{mism}")
    check(not any(mism), "mu(i->j) != mu(j->i) on some allowed slots")
    # storing x in f32 alone costs a residual of the order of the floor
    # (about 1e-2 at n = 10⁶; even the exact solution rounded to f32 lands
    # near 4e-3), far above 1e-5: hold the f32 run to 1e-5 above twice
    # that bound, and the f64 run to 1e-5 itself
    check(first["true_res"] < 1e-5 + 2 * first["floor"],
          f"float32 true residual {first['true_res']} >= 1e-5 + 2 * "
          f"{first['floor']}")
    # a second f32 run: times without first-use costs (library handles,
    # allocator growth)
    second = run(torch.float32, EXPECT_LEVELS)
    # f64 rounds μ differently from f32, so its hierarchy has its own
    # level sizes; no f32 reference applies to them
    f64 = run(torch.float64, None)
    check(f64["true_res"] < 1e-5,
          f"float64 true residual {f64['true_res']} >= 1e-5")
    first["labels"] = [l.cpu() for l in first["setup"].level_labels]
    first["warm_times"] = second["times"]
    first["launches"] = counts
    first["f64"] = f64
    return first


def log_shapes(shapes) -> None:
    """The main path's launches by kernel and shape bucket, most launched
    first: (n, S, word bytes) as ``gather.launch_shapes`` counts them."""
    for (name, n, slots, w), c in sorted(shapes.items(),
                                         key=lambda kv: (kv[0][0], -kv[1])):
        log(f"main path shape bucket: {name} n={n} S={slots} w={w} "
            f"launches={c}")


def old_route(dvals, lanes, cols, vals, x):
    """The hybrid SpMV as the card ran it before K1 took the lanes: the
    torch lane loop (a multiply and an add per lane), then K1 without
    lanes for the remainder and one add."""
    from multigridsolver_tpu_torch.ops import gather as g
    y = g.hyb_spmv_plain(dvals, lanes, None, None, x)
    return y if cols is None else y.add_(g.gather_spmv(cols, vals, x))


def hyb_args(h):
    e = h.ell
    return (h.dvals, h.lanes, None if e is None else e.cols,
            None if e is None else e.vals)


def hyb_bytes(dvals, lanes, cols, vals, x) -> tuple[int, int]:
    """What K1 with lanes must move (each input once: the lanes, the
    remainder, the x words it touches; y once) and its float operations
    (a multiply and an add per nonzero lane entry and remainder slot)."""
    import torch
    n, w = dvals.shape[1], x.element_size()
    seen = torch.zeros(x.shape[0], dtype=torch.bool, device=x.device)
    for o in lanes.offsets:
        lo, hi = max(0, -o), min(n, n - o)
        seen[lo + o:hi + o] = True
    entries = int((dvals != 0).sum())
    k = 0
    if cols is not None:
        k = cols.shape[0]
        seen[cols.reshape(-1).long()] = True
        entries += int((vals != 0).sum())
    nbytes = (dvals.numel() * w + k * n * (4 + w) + int(seen.sum()) * w
              + n * w)
    return nbytes, 2 * entries


def phase_hyb(device, main, res) -> None:
    """K1 with lanes on every level of the main path's f32 and f64
    hierarchies, on level 1 with its offsets spread past the x window's
    budget, and timed at the shapes of levels 0 and 1 (f32)."""
    import numpy as np
    import torch
    from multigridsolver_tpu_torch.ops import gather as g
    rs = np.random.RandomState(1)
    routes = set()
    for tag, run in (("float32", main), ("float64", main["f64"])):
        atol = 1e-6 if tag == "float32" else 1e-12
        for lvl, level in enumerate(run["hier"].levels):
            args = hyb_args(level.a)
            dv, lanes, cols, _ = args
            x = torch.from_numpy(rs.rand(dv.shape[1])).to(device, dv.dtype)
            route = g.hyb_route(*args, x)
            routes.add(route)
            y = g.hyb_spmv(*args, x)
            old = old_route(*args, x)
            ref = g.hyb_spmv_plain(*args, x)
            torch.cuda.synchronize()
            check(torch.equal(y, old), f"hyb_spmv {tag} level {lvl} is not "
                  "bitwise equal to the old route")
            check(torch.allclose(y, ref, rtol=atol, atol=atol),
                  f"hyb_spmv {tag} level {lvl} disagrees with its plain "
                  "version")
            err = float((y.double() - ref.double()).abs().max())
            r = res.setdefault("hyb_spmv", {"max_abs_err": 0.0})
            r["max_abs_err"] = max(r["max_abs_err"], err)
            fill = float((dv != 0).sum()) / max(dv.numel(), 1)
            log(f"hyb_spmv {tag} level {lvl}: npad={dv.shape[1]} "
                f"D={lanes.d} offset_span={lanes.omax - lanes.omin} "
                f"lane_fill={fill:.4f} "
                f"K={0 if cols is None else cols.shape[0]} route={route} "
                f"bitwise_old_route=True max_abs_err={err!r}")
    # level 1 with its offsets spread 20-fold: the window no longer fits,
    # the lanes read x through __ldg
    for tag, run in (("float32", main), ("float64", main["f64"])):
        h = run["hier"].levels[1].a
        dv, lanes, cols, vals = hyb_args(h)
        wide = g.pack_lanes([20 * o for o in lanes.offsets])
        x = torch.from_numpy(rs.rand(dv.shape[1])).to(device, dv.dtype)
        route = g.hyb_route(dv, wide, cols, vals, x)
        routes.add(route)
        y = g.hyb_spmv(dv, wide, cols, vals, x)
        atol = 1e-6 if tag == "float32" else 1e-12
        check(torch.equal(y, old_route(dv, wide, cols, vals, x)),
              f"hyb_spmv {tag} wide offsets: not bitwise the old route")
        check(torch.allclose(y, g.hyb_spmv_plain(dv, wide, cols, vals, x),
                             rtol=atol, atol=atol),
              f"hyb_spmv {tag} wide offsets disagree with the plain version")
        log(f"hyb_spmv {tag} level 1, offsets x20: D={wide.d} "
            f"offset_span={wide.omax - wide.omin} route={route} "
            "bitwise_old_route=True")
    check(routes >= {"window", "vector"}, f"hyb_spmv took routes {routes}, "
          "not both the x window and the __ldg lanes")

    def without_window(fn):
        def run():
            keep = g.WINDOW_BYTES
            g.WINDOW_BYTES = 0
            try:
                return fn()
            finally:
                g.WINDOW_BYTES = keep
        return run

    # timed at level 1 (the first shape: the JSON line's) and level 0
    for lvl in (1, 0):
        h = main["hier"].levels[lvl].a
        args = hyb_args(h)
        ell = main["setup"].matrices[lvl]
        x = torch.from_numpy(rs.rand(h.npad)).to(device, torch.float32)
        csr = csr_of(ell.cols, ell.vals, ell.slot_mask(), x.shape[0])
        log(f"hyb_spmv level {lvl}: the same operator in CSR holds "
            f"{csr.values().numel()} entries, {ell.nrows} rows")
        check(torch.allclose(torch.mv(csr, x), g.hyb_spmv(*args, x),
                             rtol=1e-4, atol=1e-4),
              f"level {lvl}: the cuSPARSE yardstick computes another "
              "function")
        ldg = without_window(lambda: g.hyb_spmv(*args, x))
        check(torch.equal(ldg(), g.hyb_spmv(*args, x)),
              f"level {lvl}: the __ldg lanes differ from the x window")
        nbytes, flops = hyb_bytes(*args, x)
        dv, lanes, cols, _ = args
        record(res, "hyb_spmv",
               f"level {lvl} f32 D={lanes.d} K="
               f"{0 if cols is None else cols.shape[0]} npad={h.npad} "
               f"route={g.hyb_route(*args, x)}", 0.0,
               lambda: g.hyb_spmv(*args, x),
               lambda: g.hyb_spmv_plain(*args, x),
               lambda: torch.mv(csr, x), nbytes, flops,
               extra={"old_route_ms": lambda: old_route(*args, x),
                      "ldg_ms": ldg})


def check_solution(tag, a_sp, b, setup, res, times, dtype, expect_levels):
    """Log and check one solve: finite x of the right shape, status 0,
    relres < 1e-6, the iteration range and (where given) the levels.
    Returns the true residual and what storing x in ``dtype`` allows."""
    import numpy as np
    import torch
    x = res.x.double().cpu().numpy()
    check(bool(np.isfinite(x).all()) and x.shape == (a_sp.shape[0],),
          f"{tag}: solution is not finite or has the wrong shape")
    nb = np.linalg.norm(b)
    true_res = float(np.linalg.norm(b - a_sp @ x) / nb)
    # what storing x in this dtype alone allows: |A (x - fl(x))| is at
    # most u |A| |x| componentwise
    floor = float(torch.finfo(dtype).eps / 2
                  * np.linalg.norm(abs(a_sp) @ np.abs(x)) / nb)
    levels = [m.nrows for m in setup.matrices]
    log(f"{tag} levels: {levels}")
    log(f"{tag} solve: iterations={res.iterations} relres={res.relres!r} "
        f"status={res.status} true_relres={true_res!r} "
        f"storage_floor={floor!r}")
    log(f"{tag} seconds: "
        + " ".join(f"{k}={v:.4f}" for k, v in times.items()))
    check(res.status == 0, f"{tag}: BiCGStab status {res.status}")
    check(res.relres < 1e-6, f"{tag}: relres {res.relres} >= 1e-6")
    if expect_levels is not None:
        check(levels == expect_levels,
              f"{tag}: levels {levels} differ from {expect_levels}")
    check(ITERS_RANGE[0] <= res.iterations <= ITERS_RANGE[1],
          f"{tag}: {res.iterations} iterations outside {ITERS_RANGE}")
    return true_res, floor


def route_of(op) -> str:
    from multigridsolver_tpu_torch.parallel import HaloOp, halo_width
    from multigridsolver_tpu_torch.utils.config import BENCH_NDEV
    if not isinstance(op, HaloOp):
        return f"plain {type(op).__name__}"
    rest = {"none": "none (pure DIA)",
            "exchange": f"exchange plan (L={op.ex_L})",
            "all_gather": "all-gather (exchange plan refused by the "
                          "L * ndev >= npad // 2 rule, as in the JAX "
                          "package)"}[op.route]
    return (f"halo (w={halo_width(op.a)}, npr={op.npad // BENCH_NDEV}), "
            f"remainder: {rest}")


def phase_sharded(device, a, unsharded) -> dict:
    """The f32 main path on a 4-shard row mesh, held to the unsharded
    run: the same levels and labels, the same iteration count."""
    import torch
    from multigridsolver_tpu_torch.ops import gather as g
    from multigridsolver_tpu_torch.parallel import (HaloOp, RowMesh,
                                                    build_amg_setup_sharded,
                                                    shard_hierarchy)
    from multigridsolver_tpu_torch.solve.api import solve_hierarchy
    from multigridsolver_tpu_torch.solve.hierarchy import build_hierarchy
    from multigridsolver_tpu_torch.utils.config import (BENCH_HIERARCHY,
                                                        BENCH_NDEV as NDEV,
                                                        bench_config)
    cfg = bench_config()
    mesh = RowMesh(NDEV, device)
    b = unsharded["b"]
    g.reset_launch_counts()
    with g.launch_shapes() as shapes:
        ell, t_ell = timed(lambda: a.to_ell(dtype=torch.float32,
                                            device=device))
        setup, t_setup = timed(lambda: build_amg_setup_sharded(ell, cfg,
                                                               mesh))
        hier, t_hier = timed(lambda: build_hierarchy(
            setup.matrices[0], setup.level_labels, setup.matrices[1:],
            **BENCH_HIERARCHY))
        hier_sh, t_shard = timed(lambda: shard_hierarchy(hier, mesh,
                                                         shard_levels=2))
        res, t_solve = timed(lambda: solve_hierarchy(
            hier_sh, b, method="bicgstab", tol=1e-6, maxiter=200))
    counts = g.launch_counts()
    times = dict(to_ell=t_ell, setup=t_setup, hierarchy=t_hier,
                 shard_hierarchy=t_shard, solve=t_solve)
    tag = f"sharded path float32 ndev={NDEV}"
    fine = setup.matrices[0]
    check(fine.shard is not None, "the finest sharded level carries no "
          "halo shard: its gathers did not take K4")
    log(f"{tag} finest level: npad={fine.npad} npr={fine.shard[1]} "
        f"h={fine.shard[2]}")
    for idx, lvl in enumerate(hier_sh.levels[:2]):
        log(f"{tag} level {idx} route: {route_of(lvl.a)}")
    check(all(isinstance(l.a, HaloOp) for l in hier_sh.levels[:2]),
          "levels 0 and 1 did not both take the halo path")
    check_solution(tag, unsharded["a_sp"], b, setup, res, times,
                   torch.float32, EXPECT_LEVELS)
    n = a.nrows
    for lvl, (mine, ref) in enumerate(zip(setup.level_labels,
                                          unsharded["labels"])):
        check(torch.equal(mine[:n].cpu(), ref[:n]),
              f"{tag}: level {lvl} labels differ from the unsharded run")
        n = int(ref.max()) + 1
    check(res.iterations == unsharded["iterations"],
          f"{tag}: {res.iterations} iterations, the unsharded run took "
          f"{unsharded['iterations']}")
    log(f"{tag} labels: bitwise equal to the unsharded run on every "
        f"level's logical rows")
    log(f"{tag} launches: {json.dumps(counts)}")
    for name, count in counts.items():
        check(count > 0, f"kernel {name} was not launched by the sharded "
              "path")
    for key, c in sorted(shapes.items(), key=lambda kv: (kv[0][0], -kv[1])):
        if key[0] in ("take_sharded", "halo_fill", "hyb_spmv_sharded"):
            log(f"{tag} shape bucket: {key[0]} n={key[1]} S={key[2]} "
                f"w={key[3]} launches={c}")
    bool_k4 = sum(c for (name, _, _, w), c in shapes.items()
                  if name == "take_sharded" and w == 1)
    check(bool_k4 > 0, f"{tag}: no bool field went through K4 as bytes")
    # one halo fill before each K4 gather and each sharded-level SpMV
    # (both halo levels have lanes off the diagonal), and one launch per
    # SpMV: the fills are the sum of the two
    check(counts["halo_fill"] == counts["take_sharded"]
          + counts["hyb_spmv_sharded"],
          f"{tag}: {counts['halo_fill']} halo fills for "
          f"{counts['take_sharded']} K4 gathers and "
          f"{counts['hyb_spmv_sharded']} sharded SpMVs")
    log(f"{tag}: bool fields through K4 as bytes: {bool_k4}; halo fills "
        f"{counts['halo_fill']} = K4 {counts['take_sharded']} + sharded "
        f"SpMV {counts['hyb_spmv_sharded']} (one launch per SpMV)")
    warm = unsharded["warm_times"]
    log("sharded vs unsharded f32 seconds (second unsharded run): "
        + " ".join(f"{k}={v:.4f}/{warm.get(k, 0.0):.4f}"
                   for k, v in times.items()))
    return counts, hier_sh


def old_sharded_route(op, x):
    """``HaloOp.spmv`` as the card ran it before ``hyb_spmv_sharded``: the
    ring halos, the torch lane loop over each shard's block, K1 on each
    shard on ``cat([x_local, recv])`` (or the all-gathered x), then the
    boundary corrections lane by lane."""
    import torch
    from multigridsolver_tpu_torch.ops import gather as g
    from multigridsolver_tpu_torch.parallel import halo_width
    from multigridsolver_tpu_torch.parallel.exchange import exchange_recv
    mesh = op.mesh
    ndev, w = mesh.ndev, halo_width(op.a)
    xs = x.view(ndev, -1)
    npr = xs.shape[1]
    if w:
        left = mesh.shift_ring(xs[:, npr - w:], 1)
        right = mesh.shift_ring(xs[:, :w], -1)
    if op.route == "exchange":
        src = torch.cat([xs, exchange_recv(xs, op.ex_send_idx, mesh)],
                        1) if op.ex_L else xs
    elif op.route == "all_gather":
        src = mesh.all_gather(xs).expand(ndev, -1)
    dv = op.a.dvals.view(len(op.offsets), ndev, npr)
    y = g.sharded_dia_interior_plain(dv, xs, op.offsets, w)
    if op.route != "none":
        y = y + torch.stack([g.gather_spmv(op.rest_cols[s], op.rest_vals[s],
                                           src[s]) for s in range(ndev)])
    if w:
        y = g.sharded_dia_corrections_plain(y, dv, left, right, op.offsets)
    return y.view(-1)


def phase_sharded_spmv(device, hier_sh, unsharded, res) -> None:
    """The sharded-level SpMV (``hyb_spmv_sharded``) at the shapes of the
    sharded hierarchy's levels 0 and 1, bitwise against its plain version
    and the route it replaced, timed beside them, the whole ``HaloOp.spmv``
    (halo fill, exchange, launch), the same operator through cuSPARSE and
    its bound (level 1 first: the JSON line's)."""
    import numpy as np
    import torch
    from multigridsolver_tpu_torch.ops import gather as g
    from multigridsolver_tpu_torch.parallel import halo_width
    from multigridsolver_tpu_torch.parallel.exchange import exchange_recv
    rs = np.random.RandomState(2)
    for lvl in (1, 0):
        op = hier_sh.levels[lvl].a
        mesh = op.mesh
        ndev, w = mesh.ndev, halo_width(op.a)
        x = torch.from_numpy(rs.rand(op.npad)).to(device, torch.float32)
        halo = mesh.boundary_halo(x, w) if w else None
        recv = exchange_recv(x.view(ndev, -1), op.ex_send_idx, mesh) \
            if op.ex_L else None
        args = (op.a.dvals, op.a.lanes, x, ndev)
        kw = dict(halo=halo, cols=op.rest_cols, vals=op.rest_vals,
                  recv=recv, route=op.route)
        y = g.hyb_spmv_sharded(*args, **kw)
        check_bits(y, g.hyb_spmv_sharded_plain(*args, **kw),
                   f"hyb_spmv_sharded level {lvl}")
        check_bits(y, old_sharded_route(op, x),
                   f"hyb_spmv_sharded level {lvl} against the old route")
        check_bits(op.spmv(x), y, f"HaloOp.spmv level {lvl}")
        ell = unsharded["setup"].matrices[lvl]
        csr = csr_of(ell.cols, ell.vals, ell.slot_mask(), x.shape[0])
        check(torch.allclose(torch.mv(csr, x)[:ell.npad], y[:ell.npad],
                             rtol=1e-4, atol=1e-4),
              f"level {lvl}: the cuSPARSE yardstick computes another "
              "function")
        route = g.hyb_spmv_sharded_route(*args, **kw)
        K = 0 if op.rest_cols is None else op.rest_cols.shape[1]
        log(f"hyb_spmv_sharded level {lvl}: ndev={ndev} npr={op.npad // ndev}"
            f" D={op.a.lanes.d} w={w} K={K} remainder={op.route} "
            f"recv={0 if recv is None else recv.shape[1]} route={route} "
            "bitwise_plain=True bitwise_old_route=True")
        wb = x.element_size()
        entries = int((op.a.dvals != 0).sum())
        nbytes = (op.a.dvals.numel() + 2 * op.npad) * wb
        for t in (halo, recv):
            nbytes += 0 if t is None else t.numel() * wb
        if K:
            entries += int((op.rest_vals != 0).sum())
            nbytes += op.rest_cols.numel() * (4 + wb)
        record(res, "hyb_spmv_sharded",
               f"level {lvl} f32 ndev={ndev} D={op.a.lanes.d} w={w} K={K} "
               f"remainder={op.route} route={route}", 0.0,
               lambda: g.hyb_spmv_sharded(*args, **kw),
               lambda: g.hyb_spmv_sharded_plain(*args, **kw),
               lambda: torch.mv(csr, x), nbytes, 2 * entries,
               extra={"old_route_ms": lambda: old_sharded_route(op, x),
                      "op_spmv_ms": lambda: op.spmv(x)})


def main() -> int:
    if not os.path.isdir(os.path.join(HERE, PKG)):
        print(f"chip_smoke: {PKG}/ not found beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    try:
        import torch
        from multigridsolver_tpu_torch.cli.generators import poisson2d
        from multigridsolver_tpu_torch.utils.config import BENCH_GRID
        kind = phase_device()
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
        phase_build()
        problem = poisson2d(BENCH_GRID)
        kres, floor_ms = phase_kernels(device, problem)
        unsharded = phase_main_path(device, problem)
        phase_hyb(device, unsharded, kres)
        sharded, hier_sh = phase_sharded(device, problem, unsharded)
        by_path = {"unsharded": unsharded["launches"], "sharded": sharded}
        phase_sharded_spmv(device, hier_sh, unsharded, kres)
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    # each path's counts were read right after its own reset: `launches`
    # is their sum, `launches_by_path` keeps them apart
    kernels = [dict(name=name, route="cuda", source=SOURCE,
                    replaces=REPLACES[name],
                    launches=sum(c[name] for c in by_path.values()),
                    launches_by_path={p: c[name] for p, c in by_path.items()},
                    **{k: kres[name][k] for k in (
                        "max_abs_err", "ms", "plain_ms", "bound_ms",
                        "bound_by", "library_ms", "old_route_ms", "ldg_ms",
                        "scalar_ms", "op_spmv_ms")
                       if k in kres[name]})
               for name in REPLACES]
    print(json.dumps({"kernels": kernels, "launch_floor_ms": floor_ms}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
