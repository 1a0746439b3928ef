"""ctypes bindings to the repository's host runtime, ``native/mgio.cpp``.

The host layer of the solver (Matrix Market parsing and writing, COO→CSR
assembly, the CMK orders and the exact sequential greedy matching) is the
C++ of ``native/mgio.cpp``, the same source the JAX package binds.  It is
compiled unchanged at first use with ``g++`` and the flags of
``native/Makefile`` into ``build/mgio/`` at the repository root (keyed by
a hash of the source, the flags and the host CPU, since ``-march=native``
ties the library to it), and loaded with ``ctypes``.

There is no fallback: when the library cannot be built or loaded, or the
parser rejects a file, these functions raise.  The pure-Python parser of
:mod:`.mtx` runs only when the caller asks for it
(``read_mtx(..., use_native=False)``); the numpy twins of
:mod:`..setup.matching` are the greedy pass's references, called by no
setup.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

from ..sparse.formats import COO, CSR

_SRC = Path(__file__).resolve().parents[2] / "native" / "mgio.cpp"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "mgio"
# native/Makefile's CXXFLAGS, and -shared for the library
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall",
             "-shared")

_lib = None
_lib_lock = threading.Lock()


def _cpu_tag() -> bytes:
    """The host CPU's model and feature flags (``-march=native`` builds
    for them)."""
    try:
        with open("/proc/cpuinfo", "rb") as f:
            lines = [l for l in f.read().splitlines()
                     if l.startswith((b"model name", b"flags"))]
    except OSError:
        return b""
    return b"\n".join(sorted(set(lines)))


def build() -> Path:
    """Compile ``native/mgio.cpp`` into a shared library (cached by the
    hash of source, flags and CPU) and return its path."""
    src = _SRC.read_bytes()
    tag = hashlib.sha256(src + " ".join(CXX_FLAGS).encode()
                         + _cpu_tag()).hexdigest()[:16]
    out = _BUILD_DIR / f"libmgio_{tag}.so"
    if out.exists():
        return out
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: native/mgio.cpp cannot be built "
                           "(set CXX or put g++ on PATH)")
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(_SRC)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{cxx} failed ({proc.returncode}) on "
                           f"{_SRC}:\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def get_lib() -> ctypes.CDLL:
    """Build if needed, load and bind the library (once); raises when it
    cannot be built or loaded."""
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            vp = ctypes.c_void_p
            i64 = ctypes.c_int64
            i64p = ctypes.POINTER(ctypes.c_int64)
            f64p = ctypes.POINTER(ctypes.c_double)
            lib.mgio_read_mtx.restype = vp
            lib.mgio_read_mtx.argtypes = [ctypes.c_char_p]
            lib.mgio_result_dims.restype = None
            lib.mgio_result_dims.argtypes = [vp, i64p]
            lib.mgio_result_fill.restype = None
            lib.mgio_result_fill.argtypes = [vp, i64p, i64p, f64p]
            lib.mgio_result_free.restype = None
            lib.mgio_result_free.argtypes = [vp]
            lib.mgio_write_mtx.restype = ctypes.c_int
            lib.mgio_write_mtx.argtypes = [ctypes.c_char_p, i64, i64, i64,
                                           i64p, i64p, f64p]
            lib.mgio_coo_to_csr.restype = i64
            lib.mgio_coo_to_csr.argtypes = [i64, i64, i64p, i64p, f64p,
                                            i64p, i64p, f64p]
            for fn in (lib.mgio_cmk_order, lib.mgio_cmk_order_genuine):
                fn.restype = None
                fn.argtypes = [i64, i64p, i64p, i64p]
            lib.mgio_greedy_pass.restype = i64
            lib.mgio_greedy_pass.argtypes = [
                i64, i64p, i64p, f64p, f64p, f64p,
                ctypes.POINTER(ctypes.c_uint8), i64p, ctypes.c_double,
                ctypes.POINTER(ctypes.c_int32)]
            _lib = lib
    return _lib


def _i64(a) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.int64)


def _f64(a) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.float64)


def _ptr(a: np.ndarray, ty):
    return a.ctypes.data_as(ctypes.POINTER(ty))


def read_mtx_native(path: str) -> COO:
    """Parse a Matrix Market coordinate file with the C++ parser (0-based
    COO, the ``symmetric`` qualifier expanded)."""
    path = os.fspath(path)
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    lib = get_lib()
    handle = lib.mgio_read_mtx(path.encode())
    if not handle:
        raise RuntimeError(f"{path}: the native parser returned nothing")
    try:
        dims = (ctypes.c_int64 * 4)()
        lib.mgio_result_dims(handle, dims)
        nrows, ncols, nnz, ok = dims[0], dims[1], dims[2], dims[3]
        if not ok:
            raise ValueError(f"{path}: the native parser rejected the file "
                             "(unreadable, or an entry line is incomplete)")
        row = np.empty(nnz, dtype=np.int64)
        col = np.empty(nnz, dtype=np.int64)
        val = np.empty(nnz, dtype=np.float64)
        lib.mgio_result_fill(handle, _ptr(row, ctypes.c_int64),
                             _ptr(col, ctypes.c_int64),
                             _ptr(val, ctypes.c_double))
    finally:
        lib.mgio_result_free(handle)
    return COO(row=row, col=col, val=val, shape=(int(nrows), int(ncols)))


def write_mtx_native(path: str, coo: COO) -> None:
    """Write ``coo`` as a 1-based ``general`` coordinate file with the C++
    writer (``%.17g`` values, one entry a line)."""
    row, col, val = _i64(coo.row), _i64(coo.col), _f64(coo.val)
    rc = get_lib().mgio_write_mtx(
        os.fspath(path).encode(), coo.shape[0], coo.shape[1], coo.nnz,
        _ptr(row, ctypes.c_int64), _ptr(col, ctypes.c_int64),
        _ptr(val, ctypes.c_double))
    if rc != 0:
        raise OSError(f"{path}: the native writer could not open the file")


def coo_to_csr_native(coo: COO) -> CSR:
    """COO→CSR (row-major sort, duplicates summed) in C++."""
    n = coo.shape[0]
    row, col, val = _i64(coo.row), _i64(coo.col), _f64(coo.val)
    indptr = np.zeros(n + 1, dtype=np.int64)
    indices = np.empty(max(coo.nnz, 1), dtype=np.int64)
    data = np.empty(max(coo.nnz, 1), dtype=np.float64)
    out = get_lib().mgio_coo_to_csr(
        n, coo.nnz, _ptr(row, ctypes.c_int64), _ptr(col, ctypes.c_int64),
        _ptr(val, ctypes.c_double), _ptr(indptr, ctypes.c_int64),
        _ptr(indices, ctypes.c_int64), _ptr(data, ctypes.c_double))
    return CSR(indptr=indptr, indices=indices[:out], data=data[:out],
               shape=coo.shape)


def cmk_order_native(csr: CSR, genuine: bool = False) -> np.ndarray:
    """The CMK visitation order in C++: the reference's simplified BFS, or
    with ``genuine=True`` the Fortran's full rule (min-degree start,
    degree-sorted fronts)."""
    lib = get_lib()
    indptr, indices = _i64(csr.indptr), _i64(csr.indices)
    order = np.empty(csr.nrows, dtype=np.int64)
    fn = lib.mgio_cmk_order_genuine if genuine else lib.mgio_cmk_order
    fn(csr.nrows, _ptr(indptr, ctypes.c_int64),
       _ptr(indices, ctypes.c_int64), _ptr(order, ctypes.c_int64))
    return order


def greedy_pass_native(csr: CSR, diag: np.ndarray, si: np.ndarray,
                       excluded: np.ndarray, order: np.ndarray,
                       ktg: float) -> np.ndarray:
    """Exact sequential greedy pairwise matching in ``order`` (the
    reference CPU algorithm) in C++: (n,) int32 labels, −1 excluded."""
    n = csr.nrows
    for name, arr in (("diag", diag), ("si", si), ("excluded", excluded),
                      ("order", order)):
        if np.shape(arr) != (n,):
            raise ValueError(f"{name} has shape {np.shape(arr)}, the "
                             f"matrix needs ({n},)")
    indptr, indices = _i64(csr.indptr), _i64(csr.indices)
    data = _f64(csr.data)
    diag, si = _f64(diag), _f64(si)
    excl = np.ascontiguousarray(excluded, dtype=np.uint8)
    order = _i64(order)
    if n and (order.min() < 0 or order.max() >= n):
        raise ValueError("order holds an index outside the matrix")
    labels = np.empty(n, dtype=np.int32)
    get_lib().mgio_greedy_pass(
        n, _ptr(indptr, ctypes.c_int64), _ptr(indices, ctypes.c_int64),
        _ptr(data, ctypes.c_double), _ptr(diag, ctypes.c_double),
        _ptr(si, ctypes.c_double), _ptr(excl, ctypes.c_uint8),
        _ptr(order, ctypes.c_int64), float(ktg),
        _ptr(labels, ctypes.c_int32))
    return labels
