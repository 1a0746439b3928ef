"""The port's host layer against the JAX package on the CPU: Matrix Market
reading and writing (the C++ runtime built from ``native/mgio.cpp`` and
the pure-Python routes), the CMK orders and the greedy matching (the C++
pass, its numpy twin, and the labels of whole greedy setups), element
access, the setup statistics, and hierarchy checkpoints in both
directions (a Chebyshev K-cycle, an ilu0 V-cycle and a smoothed
hierarchy).  Labels, files and checkpoint arrays are held bitwise,
iteration counts equal."""
import dataclasses
import io
import os
from contextlib import redirect_stderr

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from multigridsolver_tpu.cli import generators as jgen
from multigridsolver_tpu.io import mtx as jmtx
from multigridsolver_tpu.setup import aggregation as jagg
from multigridsolver_tpu.setup import matching as jmatch
from multigridsolver_tpu.solve import api as japi
from multigridsolver_tpu.solve.hierarchy import build_hierarchy as j_build
from multigridsolver_tpu.sparse import ops as jops
from multigridsolver_tpu.sparse.formats import CSR as JCSR
from multigridsolver_tpu.sparse.formats import ELL as JELL
from multigridsolver_tpu.utils import config as jcfg
from multigridsolver_tpu.utils import serialization as jser
from multigridsolver_tpu.utils import stats as jstats
from multigridsolver_tpu.utils import timing as jtiming
from multigridsolver_tpu_torch import interop
from multigridsolver_tpu_torch.cli import generators as tgen
from multigridsolver_tpu_torch.io import mtx as tmtx
from multigridsolver_tpu_torch.io import native
from multigridsolver_tpu_torch.setup import aggregation as tagg
from multigridsolver_tpu_torch.setup import matching as tmatch
from multigridsolver_tpu_torch.solve import api as tapi
from multigridsolver_tpu_torch.sparse import ops as tops
from multigridsolver_tpu_torch.sparse.formats import COO as TCOO
from multigridsolver_tpu_torch.sparse.formats import CSR as TCSR
from multigridsolver_tpu_torch.utils import config as tcfg
from multigridsolver_tpu_torch.utils import serialization as tser
from multigridsolver_tpu_torch.utils import stats as tstats
from multigridsolver_tpu_torch.utils import timing as ttiming

ROUTES = {"native": True, "python": False}


@pytest.fixture(scope="module", autouse=True)
def no_warmset():
    """MGS_NO_WARMSET for the JAX package's setups, and one torch thread:
    beside the JAX package's thread pool, torch's own threads slow the
    port's small CPU operations tenfold."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MGS_NO_WARMSET", "1")
        yield
    torch.set_num_threads(threads)


def dup_coo(cls):
    """A COO with duplicates, unsorted rows, negative zero, tiny and huge
    values and an empty row."""
    rs = np.random.RandomState(3)
    row = np.array([4, 0, 2, 2, 0, 4, 1, 4], np.int64)
    col = np.array([1, 3, 2, 2, 0, 1, 5, 0], np.int64)
    val = np.array([-0.0, 1e-300, 0.1, 0.2, -3.5e200, 1 / 3, 7.0,
                    rs.rand()])
    return cls(row=row, col=col, val=val, shape=(6, 6))


MATRICES = {
    "poisson20": (lambda: jgen.poisson2d(20), lambda: tgen.poisson2d(20)),
    "csky2d12": (lambda: jgen.csky2d(12), lambda: tgen.csky2d(12)),
    "duplicates": (lambda: dup_coo(jmtx.COO), lambda: dup_coo(TCOO)),
}


@pytest.mark.parametrize("name", MATRICES)
def test_write_mtx_bytes_equal_jax(tmp_path, name):
    jm, tm = (f() for f in MATRICES[name])
    jmtx.write_mtx(tmp_path / "jax.mtx", jm)
    tmtx.write_mtx(tmp_path / "port.mtx", tm)
    assert (tmp_path / "port.mtx").read_bytes() == \
        (tmp_path / "jax.mtx").read_bytes()


SYMMETRIC = """%%MatrixMarket matrix coordinate real symmetric
% a comment line
%
4 4 6
1 1 4.0
2 1 -1.5
2 2 4
3 2 -1e-3
4 4 2.5e+1
4 1 0.25
"""
# Matrix Market allows comments only above the size line; the C++ parser
# rejects one among the entries, the Python route skips it (as the JAX
# package's Python reader does)
INNER_COMMENT = SYMMETRIC.replace("3 2 -1e-3\n", "% inner\n3 2 -1e-3\n")


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("name", list(MATRICES) + ["symmetric"])
def test_read_mtx_equals_jax(tmp_path, name, route):
    path = tmp_path / "m.mtx"
    if name == "symmetric":
        path.write_text(SYMMETRIC)
    else:
        jmtx.write_mtx(path, MATRICES[name][0]())
    want = jmtx.read_mtx(path, use_native=False)
    got = tmtx.read_mtx(path, use_native=ROUTES[route])
    assert got.shape == want.shape
    for f in ("indptr", "indices", "data"):
        g, w = getattr(got, f), getattr(want, f)
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_native_refusals(tmp_path, monkeypatch):
    """No fallback: a truncated file, a missing file and a library that
    cannot be built all raise."""
    bad = tmp_path / "bad.mtx"
    bad.write_text("%%MatrixMarket matrix coordinate real general\n"
                   "2 2 2\n1 1 1.0\n2 2\n")
    with pytest.raises(ValueError, match="rejected"):
        native.read_mtx_native(str(bad))
    inner = tmp_path / "inner.mtx"
    inner.write_text(INNER_COMMENT)
    with pytest.raises(ValueError, match="rejected"):
        tmtx.read_mtx(inner)
    got = tmtx.read_mtx(inner, use_native=False)
    want = jmtx.read_mtx(inner, use_native=False)
    np.testing.assert_array_equal(got.data, want.data)
    np.testing.assert_array_equal(got.indices, want.indices)
    with pytest.raises(FileNotFoundError):
        tmtx.read_mtx(tmp_path / "absent.mtx")
    monkeypatch.setattr(native, "_BUILD_DIR", tmp_path / "build")
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    with pytest.raises((RuntimeError, OSError)):
        native.build()


def test_coo_to_csr_native_equals_host():
    coo = dup_coo(TCOO)
    want = coo.to_csr()
    got = native.coo_to_csr_native(coo)
    for f in ("indptr", "indices", "data"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))


def reducible():
    """Two components and an isolated node, so the orders restart."""
    import scipy.sparse as sp
    a = sp.block_diag([tgen.poisson2d(4).to_scipy(), sp.eye(1),
                       tgen.csky2d(3).to_scipy()]).tocsr()
    return TCSR.from_scipy(a)


GRAPHS = {"poisson12": lambda: tgen.poisson2d(12),
          "csky2d10": lambda: tgen.csky2d(10), "reducible": reducible}


@pytest.mark.parametrize("name", GRAPHS)
def test_cmk_orders_equal_jax(name):
    a = GRAPHS[name]()
    ja = JCSR(indptr=a.indptr, indices=a.indices, data=a.data,
              shape=a.shape)
    for genuine, twin, jtwin in (
            (False, tmatch.cmk_order_host, jmatch.cmk_order_host),
            (True, tmatch.cmk_order_genuine_host,
             jmatch.cmk_order_genuine_host)):
        want = jtwin(ja)
        np.testing.assert_array_equal(twin(a), want)
        np.testing.assert_array_equal(
            native.cmk_order_native(a, genuine=genuine), want)


def test_greedy_native_equals_numpy_twin():
    """The C++ pass and the numpy twin on the same float64 inputs, at
    csky2d(12)'s spread of coefficients, in CMK and in index order."""
    a = tgen.csky2d(12)
    rs = np.random.RandomState(1)
    diag = a.to_scipy().diagonal()
    si = -0.5 * (np.asarray(a.to_scipy().sum(1)).ravel() - diag) \
        * (1 + 0.1 * rs.rand(a.nrows))
    excl = rs.rand(a.nrows) < 0.1
    for order in (tmatch.cmk_order_host(a), np.arange(a.nrows)):
        want = tmatch.greedy_match_host(a, 10.0, excl, si, order)
        np.testing.assert_array_equal(
            native.greedy_pass_native(a, diag, si, excl, order, 10.0), want)
        np.testing.assert_array_equal(
            want, jmatch.greedy_match_host(
                JCSR(indptr=a.indptr, indices=a.indices, data=a.data,
                     shape=a.shape), 10.0, excl, si, order))
    with pytest.raises(ValueError, match="shape"):
        native.greedy_pass_native(a, diag[:5], si, excl, order, 10.0)


def test_paired_from_labels_equals_jax():
    rs = np.random.RandomState(2)
    labels = np.repeat(np.arange(300), rs.randint(1, 3, 300))
    labels = rs.permutation(np.concatenate([labels, -np.ones(40, int)]))
    labels = labels.astype(np.int32)
    np.testing.assert_array_equal(tagg.paired_from_labels_host(labels),
                                  jagg.paired_from_labels_host(labels))
    with pytest.raises(ValueError, match="pairwise"):
        tagg.paired_from_labels_host(np.array([0, 0, 0, 1], np.int32))


# greedy setups: (generator, size, with the transposed-value field, dtype,
# coarsest size)
GREEDY = {"poisson32": ("poisson2d", 32, True, "f32", 64),
          "csky2d16": ("csky2d", 16, True, "f32", 100)}
DT = {"f32": (jnp.float32, torch.float32), "f64": (jnp.float64,
                                                     torch.float64)}
AGG_GREEDY = dict(ktg=10.0, npass=2, tou=8.0, matching="greedy")


def ells(name):
    gen, n, tr, dt, _ = GREEDY[name]
    jdt, tdt = DT[dt]
    je = getattr(jgen, gen)(n).to_ell(dtype=jdt, with_transpose=tr)
    te = getattr(tgen, gen)(n).to_ell(dtype=tdt, device="cpu",
                                      with_transpose=tr)
    return je, te


@pytest.fixture(scope="module")
def greedy_ref():
    """Per problem: both ELLs, the JAX package's whole greedy setup and its
    first round (``pairwise_aggregate`` of the finest level, which the
    setup calls and keeps)."""
    out = {}
    for name, spec in GREEDY.items():
        je, te = ells(name)
        js = jagg.build_amg_setup(je, jcfg.HierarchyConfig(
            max_coarse_size=spec[4],
            aggregation=jcfg.AggregationConfig(**AGG_GREEDY)))
        out[name] = dict(je=je, te=te, setup=js, round=js.rounds[0])
    return out


def port_greedy_setup(name, te):
    return tagg.build_amg_setup(te, tcfg.HierarchyConfig(
        max_coarse_size=GREEDY[name][4],
        aggregation=tcfg.AggregationConfig(**AGG_GREEDY)))


@pytest.mark.parametrize("name", GREEDY)
def test_greedy_aggregation_equals_jax(greedy_ref, name):
    """One greedy round and a whole greedy setup: labels, pass sizes and
    every coarse operator bitwise the JAX package's."""
    r = greedy_ref[name]
    jr, js = r["round"], r["setup"]
    tr = tagg.pairwise_aggregate(r["te"], tcfg.AggregationConfig(
        **AGG_GREEDY))
    np.testing.assert_array_equal(tr.labels.numpy(), np.asarray(jr.labels))
    assert [(p.nc, p.nnz) for p in tr.passes] == \
        [(p.nc, p.nnz) for p in jr.passes]
    ts = port_greedy_setup(name, r["te"])
    assert [m.nrows for m in ts.matrices] == [m.nrows for m in js.matrices]
    assert len(ts.level_labels) >= 2
    for tl, jl in zip(ts.level_labels, js.level_labels):
        np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    for tm, jm in zip(ts.matrices[1:], js.matrices[1:]):
        np.testing.assert_array_equal(tm.vals.numpy(), np.asarray(jm.vals))


def test_get_element_equals_jax(greedy_ref):
    je, te = greedy_ref["csky2d16"]["je"], greedy_ref["csky2d16"]["te"]
    rs = np.random.RandomState(4)
    i = rs.randint(0, te.nrows, (7, 9))
    j = np.clip(i + rs.randint(-20, 21, i.shape), 0, te.ncols - 1)
    j[0] = i[0]                                   # the diagonal
    want = np.asarray(jops.get_element(je, jnp.asarray(i), jnp.asarray(j)))
    got = tops.get_element(te, torch.from_numpy(i), torch.from_numpy(j))
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want != 0).any() and (want == 0).any()


@pytest.mark.parametrize("name", GREEDY)
def test_setup_statistics_equal_jax(greedy_ref, name):
    """The pair-quality histogram of a round's labels and the coarsening
    table of a setup."""
    r = greedy_ref[name]
    labels = r["round"].labels
    want = jstats.aggregate_quality_histogram(r["je"], labels)
    got = tstats.aggregate_quality_histogram(
        r["te"], torch.from_numpy(np.array(labels)))
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1:] == want[1:]
    assert got[0].sum() > 0
    assert tstats.setup_report(port_greedy_setup(name, r["te"])) == \
        jstats.setup_report(r["setup"])


def test_timing_and_report_lines_equal_jax(tmp_path):
    """The log lines match the JAX package's but for the times; the
    memory report is empty on the CPU and a trace is written."""
    out = {}
    for key, mod in (("jax", jtiming), ("port", ttiming)):
        buf = io.StringIO()
        with redirect_stderr(buf):
            mod.print_info("matrix", "4x4, nnz=6")
            mod.print_info("a label only")
            mod.print_warn("careful")
            timer = mod.PhaseTimer()
            with timer.phase("setup.total"):
                pass
            timer.report()
        out[key] = buf.getvalue().splitlines()
    assert out["port"][:3] == out["jax"][:3]
    assert out["port"][3].split(":")[0] == out["jax"][3].split(":")[0]
    assert tstats.device_memory_report("cpu") == {}
    with tstats.trace(str(tmp_path / "tr")) as d:
        torch.ones(8).sum()
    assert os.path.getsize(os.path.join(d, "trace.json")) > 0


# ---- checkpoints -----------------------------------------------------------

SOLVE = dict(method="bicgstab", tol=1e-6, maxiter=100)
# configuration: (levels above the coarsest, hierarchy settings); the
# K-cycle recurses through two levels, the others keep one (the JAX
# package compiles a solve per hierarchy structure)
CKPT = {"chebyshev": (2, dict(smoother_kind="chebyshev", cycle="kcycle",
                              pre_smooth=1, post_smooth=1, degree=2)),
        "ilu0": (1, dict(smoother_kind="ilu0", cycle="vcycle",
                         pre_smooth=0, post_smooth=1)),
        "smoothed": (1, dict(smoother_kind="jacobi", cycle="vcycle",
                             pre_smooth=1, post_smooth=1))}


def np_ell(e) -> dict:
    """ELL arguments of ``interop`` from an ELL of either package."""
    get = (lambda t: t.numpy()) if torch.is_tensor(e.cols) else np.asarray
    return dict(cols=get(e.cols), vals=get(e.vals), rownnz=get(e.rownnz),
                nrows=e.nrows, ncols=e.ncols)


def j_ell(d: dict):
    return JELL(cols=jnp.asarray(d["cols"]), vals=jnp.asarray(d["vals"]),
                rownnz=jnp.asarray(d["rownnz"]), nrows=d["nrows"],
                ncols=d["ncols"])


@pytest.fixture(scope="module")
def ckpt(greedy_ref, tmp_path_factory):
    """The JAX hierarchies of each configuration on the greedy setup of
    poisson2d(32) in float32 (the one ``greedy_ref`` made), their counts,
    and their checkpoints.  The smoothed one takes the port's smoothed
    setup of the same matrix (P_s, Pᵀ and P_sᵀAP_s carried into the JAX
    package)."""
    d = tmp_path_factory.mktemp("ckpt")
    r = greedy_ref["poisson32"]
    # the JAX checkpoint layout has no place for a transposed-value field
    js = dataclasses.replace(r["setup"], matrices=[
        dataclasses.replace(m, vals_t=None) for m in r["setup"].matrices])
    b = np.random.RandomState(0).rand(r["te"].nrows)
    ts = tagg.build_amg_setup(
        dataclasses.replace(r["te"], vals_t=None), tcfg.HierarchyConfig(
            max_coarse_size=GREEDY["poisson32"][4], smooth_p=2.0 / 3.0,
            aggregation=tcfg.AggregationConfig(**tcfg.BENCH_AGGREGATION)))
    out = {"b": b}
    for kind, (nl, kw) in CKPT.items():
        if kind == "smoothed":
            mats = [np_ell(m) for m in ts.matrices[: nl + 1]]
            labels = [l.numpy() for l in ts.level_labels[:nl]]
            p_ops = [np_ell(p) for p in ts.p_ops[:nl]]
            pt_ops = [np_ell(p) for p in ts.pt_ops[:nl]]
            jmats = [j_ell(m) for m in mats]
            jh = j_build(jmats[0], [jnp.asarray(l) for l in labels],
                         jmats[1:], p_ops=[j_ell(p) for p in p_ops],
                         pt_ops=[j_ell(p) for p in pt_ops], **kw)
        else:
            mats = [np_ell(m) for m in js.matrices[: nl + 1]]
            labels = [np.asarray(l) for l in js.level_labels[:nl]]
            p_ops = pt_ops = None
            jh = j_build(js.matrices[0], js.level_labels[:nl],
                         js.matrices[1: nl + 1], **kw)
        res = japi.solve_hierarchy(jh, b, **SOLVE)
        path = str(d / f"{kind}_jax.npz")
        jser.save_hierarchy(path, jh)
        sm = [lvl.smoother for lvl in jh.levels]
        state = [{k: np.asarray(v) for k, v in (
            ("d", s.d), ("lvals", getattr(s.lmat, "vals", None)),
            ("uvals", getattr(s.umat, "vals", None)), ("udiag", s.udiag))
            if v is not None} for s in sm]
        out[kind] = dict(
            jax_path=path, iterations=int(res.iterations), dir=d,
            interop=interop.hierarchy_from_numpy(
                mats, labels, lmax_per_level=[float(s.lmax) for s in sm],
                smoother_state=state, device="cpu", p_ops=p_ops,
                pt_ops=pt_ops, **kw))
    return out


def assert_same(t1, t2):
    assert t1.dtype == t2.dtype
    np.testing.assert_array_equal(t1.numpy(), t2.numpy())


@pytest.mark.parametrize("kind", CKPT)
def test_jax_checkpoint_loads_in_port(ckpt, kind):
    """A JAX checkpoint, loaded by the port: bitwise the operators, labels,
    smoother state and transfers that ``interop`` builds from the same
    JAX objects, the JAX coarse LU with its pivots made 1-based, and the
    JAX solve's count."""
    c = ckpt[kind]
    h = tser.load_hierarchy(c["jax_path"], device="cpu")
    ref = c["interop"]
    assert len(h.levels) == len(ref.levels) == CKPT[kind][0]
    for lv, lr in zip(h.levels, ref.levels):
        assert lv.a.offsets == lr.a.offsets and lv.nc_pad == lr.nc_pad
        assert_same(lv.a.dvals, lr.a.dvals)
        assert (lv.a.ell is None) == (lr.a.ell is None)
        for f in ("cols", "vals", "rownnz"):
            if lr.a.ell is not None:
                assert_same(getattr(lv.a.ell, f), getattr(lr.a.ell, f))
        assert_same(lv.labels, lr.labels)
        for f in ("d", "lmax", "udiag"):
            if getattr(lr.smoother, f) is not None:
                assert_same(getattr(lv.smoother, f),
                            getattr(lr.smoother, f))
        for f in ("lmat", "umat"):
            if getattr(lr.smoother, f) is not None:
                assert_same(getattr(lv.smoother, f).vals,
                            getattr(lr.smoother, f).vals)
        assert lv.tplan.weighted == lr.tplan.weighted == (kind == "smoothed")
        for f in ("p_cols", "p_vals", "m_cols", "m_vals"):
            assert_same(getattr(lv.tplan, f), getattr(lr.tplan, f))
    with np.load(c["jax_path"]) as data:
        n = len(data.files) - 1
        np.testing.assert_array_equal(h.coarse.lu.numpy(),
                                      data[f"leaf_{n - 2}"])
        np.testing.assert_array_equal(h.coarse.piv.numpy() - 1,
                                      data[f"leaf_{n - 1}"])
    res = tapi.solve_hierarchy(h, ckpt["b"], **SOLVE)
    assert int(res.status) == 0
    assert int(res.iterations) == c["iterations"]


@pytest.mark.parametrize("kind", CKPT)
def test_port_checkpoint_loads_in_jax(ckpt, kind):
    """A port checkpoint, loaded by the JAX package, solves in the JAX
    count; loaded back by the port it solves with x bitwise the saved
    hierarchy's."""
    c = ckpt[kind]
    path = str(c["dir"] / f"{kind}_port.npz")
    tser.save_hierarchy(path, c["interop"])
    jh = jser.load_hierarchy(path)
    res = japi.solve_hierarchy(jh, ckpt["b"], **SOLVE)
    assert int(res.status) == 0
    assert int(res.iterations) == c["iterations"]
    back = tser.load_hierarchy(path, device="cpu")
    r1 = tapi.solve_hierarchy(c["interop"], ckpt["b"], **SOLVE)
    r2 = tapi.solve_hierarchy(back, ckpt["b"], **SOLVE)
    assert int(r1.iterations) == int(r2.iterations) == c["iterations"]
    np.testing.assert_array_equal(r2.x.numpy(), r1.x.numpy())
    f64 = tser.load_hierarchy(path, dtype=torch.float64, device="cpu")
    assert f64.levels[0].a.dvals.dtype == torch.float64
    assert f64.levels[0].labels.dtype == torch.int32
