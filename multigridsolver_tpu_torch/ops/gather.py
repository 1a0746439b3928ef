"""The gather kernels of the main path: wrappers, plain versions, counts.

Four hand-written CUDA kernels (``csrc/gather.cu``) carry every gather of
the AGMG main path and its row-sharded variant:

* **K1** :func:`hyb_spmv` — ``y = A @ x`` for a DIA + ELL hybrid operator
  in one launch: the DIA lanes and the ELL remainder of every
  solve-phase SpMV.  Its entry with no lanes, :func:`gather_spmv`
  (``y[i] = Σ_k vals[k, i] · x[cols[k, i]]``), carries both grid
  transfers, the plain ELL SpMV and the per-shard remainders.  Replaces
  ``windowed_gather_spmv`` (``multigridsolver_tpu/ops/gather_pallas.py``)
  and the XLA-fused DIA pass around it
  (``multigridsolver_tpu/sparse/hybrid.py``).
* **K2** :func:`take` — ``out[...] = x[idx[...]]`` for 1-, 4- and 8-byte
  words (bool fields as bytes): every neighbour-field gather of strength,
  matching, labelling and Galerkin.  Replaces ``windowed_take``.
* **K3** :func:`take_rows_many` — ``out_m[s, i] = xs_m[s, idx[i]]`` for
  up to four sources in one launch: the Galerkin member-row fetch (one
  launch per member set); :func:`take_rows` is its one-source entry.
  Replaces ``windowed_take_rows``.
* **K4** :func:`take_sharded` — K2 on a row mesh: each shard gathers from
  its own rows and an exchanged halo of ``h`` rows on either side; every
  finest-level neighbour gather of the sharded setup (bool fields as
  bytes).  :func:`halo_fill` fills that halo in one launch.  Replaces
  ``windowed_take_sharded`` (its ppermutes and its gather).
* **K1 on a row mesh** :func:`hyb_spmv_sharded` — a whole sharded-level
  SpMV (``parallel.HaloOp``, ``parallel.ExchangeELL``) in one launch for
  all shards: each shard's DIA lanes over its own block, its remainder
  from ``[x_local | recv]`` read in place (or the whole x), and the
  boundary corrections from the halo.  Replaces the XLA body of the JAX
  package's sharded SpMV (``multigridsolver_tpu/parallel/halo.py``).

Each wrapper takes its plain PyTorch version when its tensors lie on the
CPU and launches its kernel when they lie on a CUDA device; anything the
kernel does not take raises.  There is no fallback from the card to the
plain version.  Indices are clamped to the source range in both versions
(out-of-range entries are junk the callers mask).

The kernels are bound by bytes moved (see the note in ``gather.cu``).
The library is compiled with ``nvcc`` at first use into ``build/`` at the
repository root and loaded with ``ctypes``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from collections import Counter
from contextlib import contextmanager
from pathlib import Path

import torch

_SRC = Path(__file__).resolve().parent.parent / "csrc" / "gather.cu"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

# K1 takes at most this many DIA lanes (the JAX package's max_diags is 48)
MAX_LANES = 64
# shared memory K1 may give its x window: 48 KB, less room for its static
# lane table, is what a block takes without opting in to more
WINDOW_BYTES = 47 * 1024
# K1's routes (HybRoute in gather.cu)
HYB_ROUTES = ("scalar", "vector", "window")
# K2's and K3's routes (TakeRoute in gather.cu)
TAKE_ROUTES = ("scalar", "vector")
# K3 takes at most this many sources in one launch
MAX_SOURCES = 4

_lib = None
_lib_lock = threading.Lock()
# launches by kernel and shape while :func:`launch_shapes` is open
_shapes: Counter | None = None


class HybLanes(ctypes.Structure):
    """The DIA offsets of one hybrid operator as K1 takes them by value:
    the lane count, the smallest and largest offset, the offsets."""

    _fields_ = [("d", ctypes.c_int), ("omin", ctypes.c_int),
                ("omax", ctypes.c_int), ("off", ctypes.c_int * MAX_LANES)]

    @property
    def offsets(self) -> tuple:
        return tuple(self.off[:self.d])


def pack_lanes(offsets) -> HybLanes:
    """Pack DIA offsets once, for every K1 launch on their operator."""
    offsets = [int(o) for o in offsets]
    _require(len(offsets) <= MAX_LANES,
             f"{len(offsets)} DIA lanes exceed K1's {MAX_LANES}")
    return HybLanes(len(offsets), min(offsets, default=0),
                    max(offsets, default=0),
                    (ctypes.c_int * MAX_LANES)(*offsets))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the gather kernels cannot be "
                           "built (set CUDA_HOME or put nvcc on PATH)")
    return path


def build(verbose: bool = False) -> Path:
    """Compile ``csrc/gather.cu`` into a shared library (cached by the
    source's hash) and return its path."""
    src = _SRC.read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = _BUILD_DIR / f"libmgs_gather_{tag}.so"
    if out.exists():
        return out
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
           "-o", str(tmp), str(_SRC)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{proc.stdout}\n{proc.stderr}")
    if verbose:
        print(proc.stdout + proc.stderr, flush=True)
    os.replace(tmp, out)
    return out


def load_library() -> ctypes.CDLL:
    """Build if needed, load and bind the kernel library (once)."""
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            p = ctypes.c_void_p
            i = ctypes.c_int
            lanes = ctypes.POINTER(HybLanes)
            for name in ("mgs_hyb_spmv_f32", "mgs_hyb_spmv_f64"):
                fn = getattr(lib, name)
                fn.argtypes = [p, lanes, p, p, p, p, i, i, i, i, p]
                fn.restype = i
            for name in ("mgs_hyb_route_f32", "mgs_hyb_route_f64"):
                fn = getattr(lib, name)
                fn.argtypes = [p, lanes, p, p, p, i, i, i]
                fn.restype = i
            for name in ("mgs_take_w1", "mgs_take_w4", "mgs_take_w8"):
                fn = getattr(lib, name)
                fn.argtypes = [p, p, p, ctypes.c_longlong, i, p]
                fn.restype = i
            lib.mgs_take_route.argtypes = [p]
            lib.mgs_take_route.restype = i
            lib.mgs_take_rows.argtypes = [p, ctypes.POINTER(RowSources), i,
                                          i, p]
            lib.mgs_take_rows.restype = i
            lib.mgs_take_rows_route.argtypes = [p, i]
            lib.mgs_take_rows_route.restype = i
            lib.mgs_empty.argtypes = [p]
            lib.mgs_empty.restype = i
            for name in ("mgs_take_sharded_w1", "mgs_take_sharded_w4",
                         "mgs_take_sharded_w8"):
                fn = getattr(lib, name)
                fn.argtypes = [p, p, p, p, i, i, i, i, i, p]
                fn.restype = i
            lib.mgs_take_sharded_route.argtypes = [p, i]
            lib.mgs_take_sharded_route.restype = i
            for name in ("mgs_halo_fill_w1", "mgs_halo_fill_w4",
                         "mgs_halo_fill_w8"):
                fn = getattr(lib, name)
                fn.argtypes = [p, p, i, i, i, p, p, p]
                fn.restype = i
            for name in ("mgs_hyb_spmv_sharded_f32",
                         "mgs_hyb_spmv_sharded_f64"):
                fn = getattr(lib, name)
                fn.argtypes = [p, lanes, p, p, p, p, p, p, i, i, i, i, i, i,
                               i, p]
                fn.restype = i
            _lib = lib
    return _lib


def _check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {rc}")


def _on_cuda(*ts: torch.Tensor) -> bool:
    """True when every tensor lies on one CUDA device, False when all lie
    on the CPU; raises on a mix."""
    devs = {t.device for t in ts}
    if len(devs) != 1:
        raise ValueError("tensors on different devices: "
                         f"{sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type == "cuda":
        return True
    if dev.type == "cpu":
        return False
    raise ValueError(f"unsupported device {dev}")


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _check_words(t: torch.Tensor, sizes: tuple) -> None:
    """A gather source's words must be of one of ``sizes`` bytes (the
    kernels move bits; bool is a 1-byte word)."""
    _require(t.element_size() in sizes, f"gather source must hold words of "
             f"{sizes} bytes, got {t.dtype}")


def _int_max(n: int) -> None:
    _require(n < 2 ** 31, f"extent {n} exceeds the kernels' int32 indexing")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


@contextmanager
def launch_shapes():
    """Count every kernel launch inside the block by kernel and shape
    bucket ``(name, n, S, word bytes)``: n rows or index positions, S
    slots (K1, K2, K4), each source's rows (K3) or (DIA lanes, slots)
    (``hyb_spmv``); K3's word bytes per source.  Yields the Counter."""
    global _shapes
    _shapes = Counter()
    try:
        yield _shapes
    finally:
        _shapes = None


def _log_shape(name: str, n: int, s, w) -> None:
    if _shapes is not None:
        _shapes[(name, n, s, w)] += 1


def empty_launch(device: torch.device) -> None:
    """Launch an empty kernel (the floor of a launch's device time)."""
    with torch.cuda.device(device):
        _check(load_library().mgs_empty(
            torch.cuda.current_stream(device).cuda_stream), "empty")


# --------------------------------------------------------------------- K1

NO_LANES = pack_lanes(())


def gather_spmv_plain(cols: torch.Tensor, vals: torch.Tensor,
                      x: torch.Tensor) -> torch.Tensor:
    """Plain version of K1 without lanes: ``Σ_k vals[k] · x[cols[k]]``,
    the slots folded in ascending order with each product rounded before
    its add, as the kernel folds them.  (``(vals * x[cols]).sum(0)``
    reduces in that order on the CPU for K ≤ 16, but not on the card,
    where it differs in the last bits, beyond 1e-6 on coarse f32
    levels.)"""
    idx = cols.long().clamp_(0, x.shape[0] - 1)
    y = torch.zeros(cols.shape[1:], dtype=x.dtype, device=x.device)
    for k in range(cols.shape[0]):
        y.add_(vals[k] * x[idx[k]])
    return y


def hyb_spmv_plain(dvals: torch.Tensor, lanes: HybLanes,
                   cols: torch.Tensor | None, vals: torch.Tensor | None,
                   x: torch.Tensor) -> torch.Tensor:
    """Plain version of K1: the DIA lanes one by one in offsets order (a
    multiply and an add over the rows whose column ``i + o`` lies in
    [0, npad)), then the remainder through :func:`gather_spmv_plain` and
    one add."""
    n = dvals.shape[1]
    y = torch.zeros((n,), dtype=x.dtype, device=x.device)
    for d, o in enumerate(lanes.offsets):
        lo, hi = max(0, -o), min(n, n - o)
        y[lo:hi].add_(dvals[d, lo:hi] * x[lo + o:hi + o])
    if cols is not None:
        y.add_(gather_spmv_plain(cols, vals, x))
    return y


def _k1(dvals: torch.Tensor | None, lanes: HybLanes,
        cols: torch.Tensor, vals: torch.Tensor, x: torch.Tensor, npad: int,
        name: str) -> torch.Tensor:
    """Launch K1 on checked CUDA tensors; ``cols``/``vals`` may be None
    (no remainder), ``dvals`` None when there are no lanes."""
    K = 0 if cols is None else cols.shape[0]
    _int_max(max(K, lanes.d, 2) * npad)
    _int_max(x.shape[0])
    y = torch.empty((npad,), dtype=x.dtype, device=x.device)
    if npad == 0:
        return y
    lib = load_library()
    fn = lib.mgs_hyb_spmv_f32 if x.dtype == torch.float32 \
        else lib.mgs_hyb_spmv_f64
    with torch.cuda.device(x.device):
        rc = fn(None if lanes.d == 0 else dvals.data_ptr(), lanes,
                None if K == 0 else cols.data_ptr(),
                None if K == 0 else vals.data_ptr(), x.data_ptr(),
                y.data_ptr(), K, npad, x.shape[0], WINDOW_BYTES, _stream(x))
    _check(rc, name)
    return y


def _check_hyb(dvals, lanes, cols, vals, x) -> None:
    """K1's argument checks; each message is formatted only on failure,
    since this runs once per solve-phase SpMV."""
    if not (x.dim() == 1 and x.shape[0] > 0):
        raise ValueError("x must be a non-empty vector")
    if x.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"x must be float32 or float64, got {x.dtype}")
    if not (dvals.dim() == 2 and dvals.dtype == x.dtype):
        raise ValueError(f"dvals must be (D, npad) of x's {x.dtype}, got "
                         f"{dvals.dtype} {tuple(dvals.shape)}")
    D, npad = dvals.shape
    if D > MAX_LANES:
        raise ValueError(f"{D} DIA lanes exceed K1's {MAX_LANES}")
    if not (isinstance(lanes, HybLanes) and lanes.d == D):
        raise ValueError(f"lanes must be the HybLanes of dvals' {D} lanes")
    if (cols is None) != (vals is None):
        raise ValueError("cols and vals must both be given or both be None")
    if cols is not None:
        if not (cols.dim() == 2 and vals.shape == cols.shape
                and cols.shape[1] == npad):
            raise ValueError(f"cols/vals must be equal (K, {npad}), got "
                             f"{tuple(cols.shape)} and {tuple(vals.shape)}")
        if cols.dtype != torch.int32:
            raise ValueError(f"cols must be int32, got {cols.dtype}")
        if vals.dtype != x.dtype:
            raise ValueError(f"vals/x must share one dtype, got "
                             f"{vals.dtype}/{x.dtype}")
        if not (cols.is_contiguous() and vals.is_contiguous()):
            raise ValueError("K1 needs contiguous tensors")
    if D and x.shape[0] < npad:
        raise ValueError(f"the DIA lanes read x at rows < npad = {npad}, x "
                         f"has {x.shape[0]}")
    if not (dvals.is_contiguous() and x.is_contiguous()):
        raise ValueError("K1 needs contiguous tensors")


def hyb_spmv(dvals: torch.Tensor, lanes: HybLanes,
             cols: torch.Tensor | None, vals: torch.Tensor | None,
             x: torch.Tensor) -> torch.Tensor:
    """K1: ``y = A @ x`` for a DIA + ELL hybrid operator, in one launch.

    ``dvals`` ``(D, npad)``: lane ``d`` holds ``A[i, i + o_d]`` (0 where
    absent or out of range), with the offsets ``o_d`` packed in ``lanes``
    (:func:`pack_lanes`); ``cols``/``vals`` ``(K, npad)``: the slot-major
    ELL remainder, or None.  ``y[i]`` is the fold of the lanes in offsets
    order over the rows whose column lies in [0, npad), plus the fold of
    the remainder's slots (see ``gather.cu``)."""
    _check_hyb(dvals, lanes, cols, vals, x)
    if not _on_cuda(*(t for t in (dvals, cols, vals, x) if t is not None)):
        return hyb_spmv_plain(dvals, lanes, cols, vals, x)
    y = _k1(dvals, lanes, cols, vals, x, dvals.shape[1], "hyb_spmv")
    hyb_spmv.launches += 1
    if _shapes is not None:
        _log_shape("hyb_spmv", dvals.shape[1],
                   (lanes.d, 0 if cols is None else cols.shape[0]),
                   x.element_size())
    return y


hyb_spmv.launches = 0


def hyb_route(dvals: torch.Tensor, lanes: HybLanes,
              cols: torch.Tensor | None, vals: torch.Tensor | None,
              x: torch.Tensor) -> str:
    """Which instance :func:`hyb_spmv` launches for these CUDA tensors:
    ``"window"`` (16-byte loads, x window in shared memory), ``"vector"``
    (16-byte loads, lanes read x through ``__ldg``) or ``"scalar"``."""
    _check_hyb(dvals, lanes, cols, vals, x)
    K = 0 if cols is None else cols.shape[0]
    fn = load_library().mgs_hyb_route_f32 if x.dtype == torch.float32 \
        else load_library().mgs_hyb_route_f64
    return HYB_ROUTES[fn(None if lanes.d == 0 else dvals.data_ptr(), lanes,
                         None if K == 0 else cols.data_ptr(),
                         None if K == 0 else vals.data_ptr(), x.data_ptr(),
                         K, dvals.shape[1], WINDOW_BYTES)]


def gather_spmv(cols: torch.Tensor, vals: torch.Tensor,
                x: torch.Tensor) -> torch.Tensor:
    """K1 without lanes: ``y[i] = Σ_k vals[k, i] · x[cols[k, i]]`` over a
    slot-major ``(K, npad)`` ELL (invalid slots hold col 0 / val 0).
    ``x`` and ``vals`` share one dtype, float32 or float64; ``y`` is
    ``(npad,)``."""
    _require(cols.dim() == 2 and vals.shape == cols.shape,
             f"cols/vals must be equal (K, npad), got {tuple(cols.shape)} "
             f"and {tuple(vals.shape)}")
    _require(cols.dtype == torch.int32,
             f"cols must be int32, got {cols.dtype}")
    _require(x.dim() == 1 and x.shape[0] > 0, "x must be a non-empty vector")
    _require(vals.dtype == x.dtype
             and x.dtype in (torch.float32, torch.float64),
             "vals/x must share float32 or float64, got "
             f"{vals.dtype}/{x.dtype}")
    if not _on_cuda(cols, vals, x):
        return gather_spmv_plain(cols, vals, x)
    _require(cols.is_contiguous() and vals.is_contiguous()
             and x.is_contiguous(), "K1 needs contiguous tensors")
    y = _k1(None, NO_LANES, cols, vals, x, cols.shape[1], "gather_spmv")
    gather_spmv.launches += 1
    _log_shape("gather_spmv", cols.shape[1], cols.shape[0], x.element_size())
    return y


gather_spmv.launches = 0


# --------------------------------------------------------------------- K2

def take_plain(idx: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Plain version of K2: ``x[clamp(idx)]``, shaped like ``idx``."""
    return x[idx.long().clamp_(0, x.shape[0] - 1)]


def _check_take(idx: torch.Tensor, x: torch.Tensor) -> None:
    _require(idx.dtype == torch.int32, f"idx must be int32, got {idx.dtype}")
    _require(x.dim() == 1 and x.shape[0] > 0, "x must be a non-empty vector")
    _check_words(x, (1, 4, 8))


def take(idx: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """K2: ``out[...] = x[clamp(idx[...], 0, len(x) - 1)]``.

    ``idx`` is int32 of any shape (``(K, npad)`` slot fields or a 1-D
    index vector); ``x`` is a vector of 1-byte (bool, uint8, int8), 4-byte
    (float32, int32) or 8-byte (float64, int64) words.  The output has
    ``idx``'s shape and ``x``'s dtype: a bool field comes back as bool,
    its bytes gathered as they are."""
    _check_take(idx, x)
    if not _on_cuda(idx, x):
        return take_plain(idx, x)
    _require(idx.is_contiguous() and x.is_contiguous(),
             "K2 needs contiguous tensors")
    _int_max(x.shape[0])
    out = torch.empty(idx.shape, dtype=x.dtype, device=x.device)
    n = idx.numel()
    if n == 0:
        return out
    lib = load_library()
    fn = {1: lib.mgs_take_w1, 4: lib.mgs_take_w4,
          8: lib.mgs_take_w8}[x.element_size()]
    with torch.cuda.device(x.device):
        rc = fn(idx.data_ptr(), x.data_ptr(), out.data_ptr(), n, x.shape[0],
                _stream(x))
    _check(rc, "take")
    take.launches += 1
    if _shapes is not None:
        rows = idx.shape[-1] if idx.dim() else 1
        _log_shape("take", rows, n // rows, x.element_size())
    return out


take.launches = 0


def take_route(idx: torch.Tensor, x: torch.Tensor) -> str:
    """Which instance :func:`take` launches for these CUDA tensors:
    ``"vector"`` (16 bytes of output a thread: 4 words of 1 or 4 bytes, 2
    of 8; the last thread takes the tail) or ``"scalar"`` (one word a
    thread, for an ``idx`` off 16-byte alignment)."""
    _check_take(idx, x)
    return TAKE_ROUTES[load_library().mgs_take_route(idx.data_ptr())]


# --------------------------------------------------------------------- K3

class RowSources(ctypes.Structure):
    """K3's sources as its kernel takes them by value: source ``m`` is
    ``(rows[m], nsrc)`` of ``wbytes[m]``-byte words at ``src[m]``, its
    output ``(rows[m], n)`` at ``dst[m]``."""

    _fields_ = [("count", ctypes.c_int),
                ("rows", ctypes.c_int * MAX_SOURCES),
                ("wbytes", ctypes.c_int * MAX_SOURCES),
                ("src", ctypes.c_void_p * MAX_SOURCES),
                ("dst", ctypes.c_void_p * MAX_SOURCES)]


def take_rows_plain(idx: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """Plain version of K3 with one source: ``xs[:, clamp(idx)]``."""
    return xs[:, idx.long().clamp_(0, xs.shape[1] - 1)]


def take_rows_many_plain(idx: torch.Tensor, sources) -> list[torch.Tensor]:
    """Plain version of K3: :func:`take_rows_plain` of each source."""
    return [take_rows_plain(idx, xs) for xs in sources]


def _check_rows(idx: torch.Tensor, sources) -> None:
    _require(idx.dtype == torch.int32 and idx.dim() == 1,
             f"idx must be a 1-D int32 vector, got {idx.dtype} "
             f"{tuple(idx.shape)}")
    _require(1 <= len(sources) <= MAX_SOURCES,
             f"K3 takes 1 to {MAX_SOURCES} sources, got {len(sources)}")
    nsrc = sources[0].shape[-1]
    for xs in sources:
        _require(xs.dim() == 2 and xs.shape[1] == nsrc and nsrc > 0,
                 f"every source must be (S, nsrc) with one nsrc > 0, got "
                 f"{[tuple(x.shape) for x in sources]}")
        _check_words(xs, (4, 8))


def _k3(idx: torch.Tensor, sources, name: str) -> list[torch.Tensor]:
    """Launch K3 on checked CUDA tensors (``sources`` non-empty, one
    nsrc); returns one ``(S_m, len(idx))`` output per source."""
    _require(idx.is_contiguous() and all(xs.is_contiguous()
                                         for xs in sources),
             "K3 needs contiguous tensors")
    n, nsrc = idx.shape[0], sources[0].shape[1]
    for xs in sources:
        _int_max(xs.shape[0] * nsrc)
        _int_max(xs.shape[0] * n)
    outs = [torch.empty((xs.shape[0], n), dtype=xs.dtype, device=xs.device)
            for xs in sources]
    rows = sum(xs.shape[0] for xs in sources)
    _require(rows < 65536, f"K3 takes fewer than 65536 rows, got {rows}")
    if n * rows == 0:
        return outs
    spec = RowSources(len(sources))
    for m, (xs, out) in enumerate(zip(sources, outs)):
        spec.rows[m] = xs.shape[0]
        spec.wbytes[m] = xs.element_size()
        spec.src[m] = xs.data_ptr()
        spec.dst[m] = out.data_ptr()
    with torch.cuda.device(idx.device):
        rc = load_library().mgs_take_rows(idx.data_ptr(), spec, n, nsrc,
                                          _stream(idx))
    _check(rc, name)
    if _shapes is not None:
        _log_shape(name, n, tuple(xs.shape[0] for xs in sources),
                   tuple(xs.element_size() for xs in sources))
    return outs


def take_rows(idx: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """K3 with one source: ``out[s, i] = xs[s, clamp(idx[i], 0, nsrc -
    1)]`` — S source rows gathered at one int32 index vector; ``xs`` is
    ``(S, nsrc)`` of 4- or 8-byte words, the output ``(S, len(idx))``."""
    _check_rows(idx, [xs])
    if not _on_cuda(idx, xs):
        return take_rows_plain(idx, xs)
    out = _k3(idx, [xs], "take_rows")[0]
    if out.numel():
        take_rows.launches += 1
    return out


take_rows.launches = 0


def take_rows_many(idx: torch.Tensor, sources) -> list[torch.Tensor]:
    """K3: :func:`take_rows` of up to four sources at one index vector, in
    one launch.  Each source is ``(S_m, nsrc)`` (one nsrc for all) of its
    own 4- or 8-byte words; the outputs are ``(S_m, len(idx))``, in the
    sources' order."""
    sources = list(sources)
    _check_rows(idx, sources)
    if not _on_cuda(idx, *sources):
        return take_rows_many_plain(idx, sources)
    outs = _k3(idx, sources, "take_rows_many")
    if any(out.numel() for out in outs):
        take_rows_many.launches += 1
    return outs


take_rows_many.launches = 0


def take_rows_route(idx: torch.Tensor, sources) -> str:
    """Which instance :func:`take_rows_many` (and :func:`take_rows`)
    launches for these CUDA tensors: ``"vector"`` (16 bytes of a row a
    thread; ``len(idx) % 4 == 0`` and ``idx`` 16-byte aligned) or
    ``"scalar"``."""
    sources = list(sources)
    _check_rows(idx, sources)
    return TAKE_ROUTES[load_library().mgs_take_rows_route(idx.data_ptr(),
                                                          idx.shape[0])]


# --------------------------------------------------------------------- K4

# K4's, halo_fill's and hyb_spmv_sharded's grids take the shards (and K4's
# the slot rows) on their y and z axes
MAX_GRID_YZ = 65535


def halo_fill_plain(x: torch.Tensor, ndev: int, h: int,
                    lo: torch.Tensor | None = None,
                    hi: torch.Tensor | None = None) -> torch.Tensor:
    """Plain version of :func:`halo_fill`: the two non-cyclic shifts of
    the boundary slabs, the outer edges ``lo``/``hi`` (zeros where
    None)."""
    xs = x.view(ndev, -1)
    halo = x.new_zeros((ndev, 2, h))
    if h:
        halo[1:, 0] = xs[:-1, xs.shape[1] - h:]
        halo[:-1, 1] = xs[1:, :h]
        if lo is not None:
            halo[0, 0] = lo
        if hi is not None:
            halo[-1, 1] = hi
    return halo


def halo_fill(x: torch.Tensor, ndev: int, h: int,
              lo: torch.Tensor | None = None,
              hi: torch.Tensor | None = None) -> torch.Tensor:
    """The halo K4 and :func:`hyb_spmv_sharded` read: ``(ndev, 2, h)``
    with ``[s, 0]`` the last ``h`` words of shard ``s − 1`` and ``[s, 1]``
    the first ``h`` of shard ``s + 1``, for ``x`` split into ``ndev``
    shards of ``npr ≥ h`` words of 1, 4 or 8 bytes.  The outer edges
    ``[0, 0]`` and ``[ndev − 1, 1]`` are ``lo`` and ``hi`` (``(h,)``: on a
    mesh over ranks, the slabs received from the neighbour ranks), zeros
    where None (the mesh ends).  One launch on the card (the body of the
    two ppermutes of ``windowed_take_sharded``)."""
    _require(x.dim() == 1 and ndev >= 1 and x.shape[0] % ndev == 0,
             f"x must split into {ndev} shards, got {tuple(x.shape)}")
    npr = x.shape[0] // ndev
    _require(0 <= h <= npr, f"halo width {h} must lie in [0, {npr}]")
    _check_words(x, (1, 4, 8))
    for edge in (lo, hi):
        _require(edge is None or (edge.shape == (h,)
                                  and edge.dtype == x.dtype),
                 f"an outer edge must be ({h},) of x's {x.dtype}")
    edges = [e for e in (lo, hi) if e is not None]
    if not _on_cuda(x, *edges):
        return halo_fill_plain(x, ndev, h, lo, hi)
    _require(x.is_contiguous() and all(e.is_contiguous() for e in edges),
             "halo_fill needs contiguous tensors")
    _require(2 * ndev <= MAX_GRID_YZ, f"{ndev} shards exceed halo_fill's "
             "grid")
    _int_max(x.shape[0])
    halo = torch.empty((ndev, 2, h), dtype=x.dtype, device=x.device)
    if h == 0:
        return halo
    lib = load_library()
    fn = {1: lib.mgs_halo_fill_w1, 4: lib.mgs_halo_fill_w4,
          8: lib.mgs_halo_fill_w8}[x.element_size()]
    with torch.cuda.device(x.device):
        rc = fn(x.data_ptr(), halo.data_ptr(), ndev, npr, h,
                None if lo is None else lo.data_ptr(),
                None if hi is None else hi.data_ptr(), _stream(x))
    _check(rc, "halo_fill")
    halo_fill.launches += 1
    _log_shape("halo_fill", npr, ndev, x.element_size())
    return halo


halo_fill.launches = 0


def take_sharded_plain(idx: torch.Tensor, x: torch.Tensor, halo: torch.Tensor,
                       npr: int, h: int, base: int = 0) -> torch.Tensor:
    """Plain version of K4: per shard, ``take_plain`` of the rebased
    indices on ``cat([lo, x_local, hi])``."""
    outs = []
    for s in range(halo.shape[0]):
        src = torch.cat([halo[s, 0], x[s * npr:(s + 1) * npr], halo[s, 1]])
        outs.append(take_plain(idx[..., s * npr:(s + 1) * npr]
                               - (base + s * npr - h), src))
    return torch.cat(outs, -1)


def _check_take_sharded(idx, x, halo, npr, h) -> None:
    _require(idx.dtype == torch.int32, f"idx must be int32, got {idx.dtype}")
    ndev = halo.shape[0]
    _require(halo.dim() == 3 and halo.shape[1:] == (2, h) and 0 <= h <= npr,
             f"halo must be (ndev, 2, h) with 0 <= h <= npr, got "
             f"{tuple(halo.shape)}, h={h}, npr={npr}")
    _require(x.dim() == 1 and x.shape[0] == ndev * npr and npr > 0,
             f"x must hold ndev * npr = {ndev * npr} words, got "
             f"{tuple(x.shape)}")
    _require(idx.dim() in (1, 2) and idx.shape[-1] == ndev * npr,
             f"idx must be (K, {ndev * npr}) or ({ndev * npr},), got "
             f"{tuple(idx.shape)}")
    _require(halo.dtype == x.dtype, f"halo {halo.dtype} and x {x.dtype} "
             "must share one dtype")
    _check_words(x, (1, 4, 8))


def take_sharded(idx: torch.Tensor, x: torch.Tensor, halo: torch.Tensor,
                 npr: int, h: int, base: int = 0) -> torch.Tensor:
    """K4: the neighbour gather of a row-sharded operator.

    The rows (the last axis of ``idx``, ``ndev * npr`` long) are split into
    ``ndev`` shards of ``npr``; shard ``s`` reads ``x`` at global indices in
    ``[base + s·npr − h, base + (s+1)·npr + h)``, its own block of ``x``
    directly and the ``h`` rows on either side from ``halo`` ``(ndev, 2,
    h)`` (the neighbours' boundary slabs, zero at the mesh ends:
    :func:`halo_fill`).
    Indices outside that range are clamped into it (junk the callers
    mask).  ``idx`` is int32 ``(K, ndev·npr)`` or ``(ndev·npr,)``; ``x``
    ``(ndev·npr,)`` and ``halo`` hold one dtype of 1-, 4- or 8-byte words
    (a bool field is gathered as its bytes).  The indices are global and
    ``base`` is the global index of ``x``'s first row: 0 on one process,
    the rank's first row when ``x`` is a rank's local block of a mesh
    over ranks."""
    _check_take_sharded(idx, x, halo, npr, h)
    _int_max(base + x.shape[0] + h)
    if not _on_cuda(idx, x, halo):
        return take_sharded_plain(idx, x, halo, npr, h, base)
    _require(idx.is_contiguous() and x.is_contiguous()
             and halo.is_contiguous(), "K4 needs contiguous tensors")
    ndev = halo.shape[0]
    _int_max(ndev * npr + 2 * h)
    _int_max(idx.numel())
    out = torch.empty(idx.shape, dtype=x.dtype, device=x.device)
    n = idx.numel()
    if n == 0:
        return out
    K = n // idx.shape[-1]
    _require(K <= MAX_GRID_YZ and ndev <= MAX_GRID_YZ,
             f"K4 takes at most {MAX_GRID_YZ} slot rows and shards, got "
             f"{K} and {ndev}")
    lib = load_library()
    fn = {1: lib.mgs_take_sharded_w1, 4: lib.mgs_take_sharded_w4,
          8: lib.mgs_take_sharded_w8}[x.element_size()]
    with torch.cuda.device(x.device):
        rc = fn(idx.data_ptr(), x.data_ptr(), halo.data_ptr(),
                out.data_ptr(), K, ndev, npr, h, base, _stream(x))
    _check(rc, "take_sharded")
    take_sharded.launches += 1
    _log_shape("take_sharded", idx.shape[-1], K, x.element_size())
    return out


take_sharded.launches = 0


def take_sharded_route(idx: torch.Tensor, x: torch.Tensor,
                       halo: torch.Tensor, npr: int, h: int) -> str:
    """Which instance :func:`take_sharded` launches for these CUDA
    tensors: ``"vector"`` (16 bytes of output a thread, as K2; ``npr % 4 ==
    0`` and ``idx`` 16-byte aligned) or ``"scalar"`` (one word a
    thread)."""
    _check_take_sharded(idx, x, halo, npr, h)
    return TAKE_ROUTES[load_library().mgs_take_sharded_route(idx.data_ptr(),
                                                             npr)]


# ------------------------------------------------------ K1 on a row mesh

SHARDED_ROUTES = ("none", "exchange", "all_gather")


def sharded_dia_interior_plain(dvals: torch.Tensor, xs: torch.Tensor,
                               offsets, w: int) -> torch.Tensor:
    """The DIA lanes of every shard over its own block only (zeros beyond
    its ends), a multiply and an add per lane in offsets order.
    ``dvals`` ``(D, ndev, npr)``, ``xs`` ``(ndev, npr)``; ``w`` ≥ every
    ``|o|``."""
    npr = xs.shape[1]
    xz = torch.nn.functional.pad(xs, (w, w)) if w else xs
    y = torch.zeros_like(xs)
    for d, o in enumerate(offsets):
        y = y + dvals[d] * xz[:, w + o:w + o + npr]
    return y


def sharded_dia_corrections_plain(y: torch.Tensor, dvals: torch.Tensor,
                                  left: torch.Tensor, right: torch.Tensor,
                                  offsets) -> torch.Tensor:
    """Add the boundary terms the interior left out: rows i < w fold the
    lanes with i + o < 0 from the left halo, rows i ≥ npr − w the lanes
    with i + o ≥ npr from the right halo (``left``/``right`` ``(ndev,
    w)``; w may exceed npr), each fold from +0 in offsets order; the head
    is added before the tail."""
    npr, w = y.shape[1], left.shape[1]
    m = min(w, npr)
    ih = torch.arange(m, device=y.device)           # rows i < w
    it = torch.arange(npr - m, npr, device=y.device)  # rows i ≥ npr − w
    head = y.new_zeros((y.shape[0], m))
    tail = y.new_zeros((y.shape[0], m))
    for d, o in enumerate(offsets):
        if o < 0:
            # row i wants x_local[i + o]; i + o < 0 → left[w + i + o]
            idx = (w + ih + o).clamp(0, w - 1)
            head = head + torch.where(ih + o < 0,
                                      dvals[d][:, :m] * left[:, idx], 0.0)
        elif o > 0:
            # i + o ≥ npr → right[i + o − npr]
            idx = (it + o - npr).clamp(0, w - 1)
            tail = tail + torch.where(
                it + o >= npr, dvals[d][:, npr - m:] * right[:, idx], 0.0)
    y = y.clone()
    y[:, :m] += head
    y[:, npr - m:] += tail
    return y


def hyb_spmv_sharded_plain(dvals: torch.Tensor | None, lanes: HybLanes,
                           x: torch.Tensor, ndev: int,
                           halo: torch.Tensor | None = None,
                           cols: torch.Tensor | None = None,
                           vals: torch.Tensor | None = None,
                           recv: torch.Tensor | None = None,
                           route: str = "none") -> torch.Tensor:
    """Plain version of :func:`hyb_spmv_sharded`: the interior, then the
    remainder of every shard (:func:`gather_spmv_plain` on
    ``[x_local | recv[s]]`` or on the whole x) and one add, then the
    boundary corrections."""
    npr = x.shape[0] // ndev
    xs = x.view(ndev, npr)
    w = 0 if halo is None else halo.shape[2]
    dv = None if dvals is None else dvals.view(lanes.d, ndev, npr)
    y = sharded_dia_interior_plain(dv, xs, lanes.offsets, w)
    if route != "none":
        if route == "all_gather":
            src = x.expand(ndev, -1)
        else:
            src = xs if recv is None else torch.cat([xs, recv], 1)
        y = y + torch.stack([gather_spmv_plain(cols[s], vals[s], src[s])
                             for s in range(ndev)])
    if w:
        y = sharded_dia_corrections_plain(y, dv, halo[:, 0], halo[:, 1],
                                          lanes.offsets)
    return y.view(-1)


def _check_hyb_sharded(dvals, lanes, x, ndev, halo, cols, vals, recv,
                       route) -> None:
    """:func:`hyb_spmv_sharded`'s argument checks (formatted only on
    failure: this runs once per sharded-level SpMV)."""
    if route not in SHARDED_ROUTES:
        raise ValueError(f"route must be one of {SHARDED_ROUTES}, got "
                         f"{route!r}")
    if not (x.dim() == 1 and ndev >= 1 and x.shape[0] % ndev == 0
            and x.shape[0] > 0):
        raise ValueError(f"x must split into {ndev} non-empty shards, got "
                         f"{tuple(x.shape)}")
    if x.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"x must be float32 or float64, got {x.dtype}")
    npad = x.shape[0]
    npr = npad // ndev
    if not isinstance(lanes, HybLanes):
        raise ValueError("lanes must be a HybLanes")
    if lanes.d == 0:
        if dvals is not None and dvals.shape[0] != 0:
            raise ValueError("dvals must be None or (0, npad) without lanes")
    elif not (dvals is not None and dvals.dim() == 2
              and dvals.shape == (lanes.d, npad) and dvals.dtype == x.dtype):
        got = None if dvals is None else (dvals.dtype, tuple(dvals.shape))
        raise ValueError(f"dvals must be ({lanes.d}, {npad}) of x's "
                         f"{x.dtype}, got {got}")
    w = 0 if halo is None else halo.shape[-1]
    if halo is not None and not (halo.dim() == 3
                                 and halo.shape[:2] == (ndev, 2)
                                 and halo.dtype == x.dtype):
        raise ValueError(f"halo must be ({ndev}, 2, w) of x's {x.dtype}, got "
                         f"{halo.dtype} {tuple(halo.shape)}")
    if lanes.d and not max(-lanes.omin, lanes.omax) <= w:
        raise ValueError(f"the halo width {w} must cover the offsets "
                         f"[{lanes.omin}, {lanes.omax}]")
    if (route == "none") != (cols is None) or (cols is None) != (vals is None):
        raise ValueError(f"route {route!r}: cols and vals must be given "
                         "exactly when the route has a remainder")
    if cols is not None:
        if not (cols.dim() == 3 and cols.shape[0] == ndev
                and cols.shape[2] == npr and vals.shape == cols.shape):
            raise ValueError(f"cols/vals must be equal ({ndev}, K, {npr}), "
                             f"got {tuple(cols.shape)} and "
                             f"{tuple(vals.shape)}")
        if cols.dtype != torch.int32 or vals.dtype != x.dtype:
            raise ValueError(f"cols must be int32 and vals {x.dtype}, got "
                             f"{cols.dtype} and {vals.dtype}")
    if recv is not None and not (route == "exchange" and recv.dim() == 2
                                 and recv.shape[0] == ndev
                                 and recv.dtype == x.dtype):
        raise ValueError(f"recv must be ({ndev}, n) of x's {x.dtype} on the "
                         f"exchange route, got {recv.dtype} "
                         f"{tuple(recv.shape)} on {route!r}")


def hyb_spmv_sharded(dvals: torch.Tensor | None, lanes: HybLanes,
                     x: torch.Tensor, ndev: int,
                     halo: torch.Tensor | None = None,
                     cols: torch.Tensor | None = None,
                     vals: torch.Tensor | None = None,
                     recv: torch.Tensor | None = None,
                     route: str = "none") -> torch.Tensor:
    """K1 on a row mesh: ``y = A @ x`` for a row-sharded operator, every
    shard in one launch.

    ``x`` ``(ndev·npr,)``; shard ``s`` owns rows ``[s·npr, (s+1)·npr)``.
    ``dvals`` ``(D, ndev·npr)`` holds the DIA lanes of ``lanes`` (None
    without lanes); each shard folds them over its own block of x, and the
    terms that leave it come back from ``halo`` ``(ndev, 2, w)``
    (:func:`halo_fill`, ``w`` ≥ every ``|o|``; None when every offset is
    0) as boundary corrections.  ``cols``/``vals`` ``(ndev, K, npr)`` hold
    each shard's ELL remainder: on the ``"exchange"`` route its columns
    address ``[x_local | recv[s]]`` (``recv`` ``(ndev, n)`` from the
    index-list exchange, or None), on ``"all_gather"`` the whole x; route
    ``"none"`` has no remainder.  ``y = ((interior + remainder) + head) +
    tail`` per row, as :func:`hyb_spmv_sharded_plain` computes it, bit for
    bit (see ``gather.cu``)."""
    _check_hyb_sharded(dvals, lanes, x, ndev, halo, cols, vals, recv, route)
    ts = [t for t in (dvals, x, halo, cols, vals, recv) if t is not None]
    if not _on_cuda(*ts):
        return hyb_spmv_sharded_plain(dvals, lanes, x, ndev, halo, cols,
                                      vals, recv, route)
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("hyb_spmv_sharded needs contiguous tensors")
    npad = x.shape[0]
    npr = npad // ndev
    K = 0 if cols is None else cols.shape[1]
    nrecv = 0 if recv is None else recv.shape[1]
    w = 0 if halo is None else halo.shape[2]
    _int_max(max(K, lanes.d, 2) * npad)
    _int_max(ndev * (npr + nrecv))
    if ndev > MAX_GRID_YZ:
        raise ValueError(f"{ndev} shards exceed the kernel's grid")
    y = torch.empty((npad,), dtype=x.dtype, device=x.device)
    lib = load_library()
    fn = lib.mgs_hyb_spmv_sharded_f32 if x.dtype == torch.float32 \
        else lib.mgs_hyb_spmv_sharded_f64
    with torch.cuda.device(x.device):
        rc = fn(None if lanes.d == 0 else dvals.data_ptr(), lanes,
                None if K == 0 else cols.data_ptr(),
                None if K == 0 else vals.data_ptr(), x.data_ptr(),
                None if nrecv == 0 else recv.data_ptr(),
                None if w == 0 else halo.data_ptr(), y.data_ptr(), K, ndev,
                npr, nrecv, int(route == "all_gather"), w, WINDOW_BYTES,
                _stream(x))
    _check(rc, "hyb_spmv_sharded")
    hyb_spmv_sharded.launches += 1
    if _shapes is not None:
        _log_shape("hyb_spmv_sharded", npr, (lanes.d, K, ndev, w),
                   x.element_size())
    return y


hyb_spmv_sharded.launches = 0


def hyb_spmv_sharded_route(dvals: torch.Tensor | None, lanes: HybLanes,
                           x: torch.Tensor, ndev: int,
                           halo: torch.Tensor | None = None,
                           cols: torch.Tensor | None = None,
                           vals: torch.Tensor | None = None,
                           recv: torch.Tensor | None = None,
                           route: str = "none") -> str:
    """Which instance :func:`hyb_spmv_sharded` launches for these CUDA
    tensors: K1's routes (``"window"``, ``"vector"``, ``"scalar"``),
    decided on one shard's ``npr`` rows."""
    _check_hyb_sharded(dvals, lanes, x, ndev, halo, cols, vals, recv, route)
    K = 0 if cols is None else cols.shape[1]
    lib = load_library()
    fn = lib.mgs_hyb_route_f32 if x.dtype == torch.float32 \
        else lib.mgs_hyb_route_f64
    return HYB_ROUTES[fn(None if lanes.d == 0 else dvals.data_ptr(), lanes,
                         None if K == 0 else cols.data_ptr(),
                         None if K == 0 else vals.data_ptr(), x.data_ptr(),
                         K, x.shape[0] // ndev, WINDOW_BYTES)]


KERNELS = {"gather_spmv": gather_spmv, "hyb_spmv": hyb_spmv, "take": take,
           "take_rows": take_rows, "take_rows_many": take_rows_many,
           "take_sharded": take_sharded, "halo_fill": halo_fill,
           "hyb_spmv_sharded": hyb_spmv_sharded}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in KERNELS.items()}
