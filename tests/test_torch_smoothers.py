"""The port's smoothers against the JAX package's plan-free CPU path:
the Jacobi diagonals and sweeps, two-stage Gauss-Seidel on the ELL and on
the DIA+ELL hybrid (the split triangular hybrids against the plain
``spmv_tri``), the ILU(0) factorisation (also against a sequential IKJ
ILU(0)) and its application, and ``galerkin_ell`` for aggregates of two
and four nodes; each on poisson2d(32) and csky3d(10) with a few
scattered entries added (so that the hybrid keeps an ELL remainder), in
float32 and float64.

Vectors and factors are held to rtol 1e-6 (f32) / 1e-12 (f64); on this
CPU the diagonals, gs2 on poisson, the triangular SpMVs and the ILU(0)
factors come out bitwise, and ``galerkin_ell``'s Ac must."""
import dataclasses

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp
from multigridsolver_tpu.cli import generators as jgen
from multigridsolver_tpu.setup.galerkin import galerkin_ell as j_galerkin
from multigridsolver_tpu.solve import smoothers as jsm
from multigridsolver_tpu.sparse import hybrid as jhyb
from multigridsolver_tpu.sparse.formats import CSR as JCSR
from multigridsolver_tpu_torch.cli import generators as tgen
from multigridsolver_tpu_torch.ops import gather
from multigridsolver_tpu_torch.parallel import RowMesh, shard_hierarchy
from multigridsolver_tpu_torch.setup.galerkin import galerkin_ell
from multigridsolver_tpu_torch.solve import smoothers as tsm
from multigridsolver_tpu_torch.solve.hierarchy import build_hierarchy
from multigridsolver_tpu_torch.sparse import hybrid as thyb
from multigridsolver_tpu_torch.sparse import ops as tops
from multigridsolver_tpu_torch.sparse.formats import CSR as TCSR

DTYPES = {"f32": (jnp.float32, torch.float32, 1e-6),
          "f64": (jnp.float64, torch.float64, 1e-12)}
PROBLEMS = {"poisson32": lambda: tgen.poisson2d(32),
            "csky10": lambda: tgen.csky3d(10)}
CASES = [(p, d) for p in PROBLEMS for d in DTYPES]


@pytest.fixture(scope="module", autouse=True)
def no_warmset():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MGS_NO_WARMSET", "1")
        yield


def scattered(a) -> sp.csr_matrix:
    """``a`` plus 40 symmetric entries far off its stencil: too few on any
    diagonal to make a DIA lane, so the hybrid keeps them as remainder."""
    rs = np.random.RandomState(11)
    n = a.shape[0]
    i = rs.randint(0, n, 40)
    j = (i + rs.randint(n // 4, n // 2, 40)) % n
    extra = sp.coo_matrix((-0.05 * rs.rand(40), (i, j)), shape=(n, n))
    m = (a.to_scipy() + extra + extra.T).tocsr()
    m.sort_indices()
    return m


@pytest.fixture(scope="module")
def ops_():
    """Per (problem, dtype): the same operator as JAX and port ELL and
    hybrid, and seeded vectors b, x."""
    out = {}
    for name, gen in PROBLEMS.items():
        m = scattered(gen())
        for dt, (jdt, tdt, _) in DTYPES.items():
            je = JCSR.from_scipy(m).to_ell(dtype=jdt)
            te = TCSR.from_scipy(m).to_ell(dtype=tdt, device="cpu")
            rs = np.random.RandomState(3)
            b, x = (np.where(np.arange(te.npad) < te.nrows,
                             rs.rand(te.npad), 0.0).astype(np.dtype(jdt))
                    for _ in range(2))
            out[name, dt] = dict(je=je, te=te,
                                 jh=jhyb.hybrid_from_ell_device(je),
                                 th=thyb.hybrid_from_ell(te), b=b, x=x,
                                 factors=jsm.ilu0_factor(je, sweeps=5))
    return out


def jax_smoother(o, ja, kind):
    """The JAX package's ``make_smoother`` (ilu0 on the factors the
    fixture computed once with it)."""
    if kind != "ilu0":
        return jsm.make_smoother(ja, kind=kind, ell=o["je"])
    lv, uv, ud = o["factors"]
    return jsm.Smoother(d=jsm.jacobi_diag(ja), lmax=jnp.asarray(1.0),
                        lmat=dataclasses.replace(o["je"], vals=lv),
                        umat=dataclasses.replace(o["je"], vals=uv),
                        udiag=ud, kind="ilu0")


def close(got, want, rtol):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * np.abs(want).max())


def operators(o, route):
    return (o["je"], o["te"]) if route == "ell" else (o["jh"], o["th"])


@pytest.mark.parametrize("problem,dt", CASES)
def test_hybrid_keeps_a_remainder_and_both_triangles(ops_, problem, dt):
    th = ops_[problem, dt]["th"]
    assert th.ell is not None
    assert th.offsets == ops_[problem, dt]["jh"].offsets
    assert min(th.offsets) < 0 < max(th.offsets)


@pytest.mark.parametrize("route", ["ell", "hyb"])
@pytest.mark.parametrize("kind", ["jacobi", "l1jacobi", "gs2", "ilu0"])
@pytest.mark.parametrize("problem,dt", CASES)
def test_smoothing_diagonal_bitwise(ops_, problem, dt, kind, route):
    o = ops_[problem, dt]
    ja, ta = operators(o, route)
    l1 = kind == "l1jacobi"
    np.testing.assert_array_equal(tsm.jacobi_diag(ta, l1=l1).numpy(),
                                  np.asarray(jsm.jacobi_diag(ja, l1=l1)))


@pytest.mark.parametrize("route", ["ell", "hyb"])
@pytest.mark.parametrize("kind", ["jacobi", "l1jacobi", "gs2", "ilu0"])
@pytest.mark.parametrize("problem,dt", CASES)
def test_smoother_apply_matches_jax(ops_, problem, dt, kind, route):
    """``make_smoother(...).apply`` (gs2 on the split triangular parts,
    ilu0 on its own factors) against the JAX smoother's."""
    o = ops_[problem, dt]
    ja, ta = operators(o, route)
    js = jax_smoother(o, ja, kind)
    ts = tsm.make_smoother(ta, kind=kind, ell=o["te"])
    assert float(ts.lmax) == 1.0
    got = ts.apply(ta, torch.from_numpy(o["b"]), torch.from_numpy(o["x"]))
    want = js.apply(ja, jnp.asarray(o["b"]), jnp.asarray(o["x"]))
    close(got, want, DTYPES[dt][2])


@pytest.mark.parametrize("problem,dt", CASES)
def test_jacobi_sweeps_and_gs2_apply(ops_, problem, dt):
    """The functions themselves, with the JAX diagonal, 3 sweeps and 3
    inner sweeps; gs2 on the hybrid builds its triangular parts itself."""
    o = ops_[problem, dt]
    rtol = DTYPES[dt][2]
    d = jsm.jacobi_diag(o["jh"], l1=True)
    td = torch.from_numpy(np.array(d))
    b, x = torch.from_numpy(o["b"]), torch.from_numpy(o["x"])
    jb, jx = jnp.asarray(o["b"]), jnp.asarray(o["x"])
    close(tsm.jacobi_sweeps(o["th"], td, b, x, 3, 0.6),
          jsm.jacobi_sweeps(o["jh"], d, jb, jx, 3, 0.6), rtol)
    close(tsm.gs2_apply(o["th"], td, b, x, 3, 3),
          jsm.gs2_apply(o["jh"], d, jb, jx, 3, 3), rtol)


@pytest.mark.parametrize("lower", [True, False])
@pytest.mark.parametrize("problem,dt", CASES)
def test_triangular_spmv(ops_, problem, dt, lower):
    """The plain ``spmv_tri`` against JAX's, and the split hybrid (K1's
    plain version on CPU tensors) against the plain ``spmv_tri``; the
    split keeps the lanes of one sign and the remainder's slot pattern."""
    o = ops_[problem, dt]
    rtol = DTYPES[dt][2]
    x = torch.from_numpy(o["x"])
    plain = thyb.spmv_tri(o["th"], x, lower)
    close(plain, jhyb.spmv_tri(o["jh"], jnp.asarray(o["x"]), lower), rtol)
    part = thyb.triangular_part(o["th"], lower)
    assert all((off < 0) == lower and off != 0 for off in part.offsets)
    assert part.ell.cols is o["th"].ell.cols
    close(tops.spmv(part, x), plain.numpy(), rtol)
    # the ELL route: the masked ELLs give the same product
    lo, up = tsm.split_triangular(o["te"])
    close(tops.spmv(lo if lower else up, x), plain.numpy(), rtol)


@pytest.mark.parametrize("problem,dt", CASES)
def test_ilu0_factor_matches_jax(ops_, problem, dt):
    o = ops_[problem, dt]
    rtol = DTYPES[dt][2]
    for got, want in zip(tsm.ilu0_factor(o["te"], sweeps=5), o["factors"]):
        close(got, want, rtol)


def ikj_ilu0(ad):
    """Sequential IKJ ILU(0) (Saad, Alg. 10.4) on a dense copy, updates
    restricted to the sparsity pattern."""
    n = ad.shape[0]
    pat = ad != 0.0
    f = ad.copy()
    for i in range(1, n):
        for k in range(i):
            if pat[i, k]:
                f[i, k] /= f[k, k]
                for j in range(k + 1, n):
                    if pat[i, j]:
                        f[i, j] -= f[i, k] * f[k, j]
    return f


def test_ilu0_factor_reaches_sequential_ilu0():
    """With 40 sweeps the Chow–Patel fixed point is the exact ILU(0)."""
    a = tgen.poisson2d(7)
    te = a.to_ell(dtype=torch.float64, device="cpu")
    n = a.shape[0]
    lv, uv, ud = (t.numpy() for t in tsm.ilu0_factor(te, sweeps=40))
    got = np.zeros((n, n))
    cols = te.cols.numpy()[:, :n]
    ri = np.arange(n)
    for s in range(te.k):
        valid = s < te.rownnz.numpy()[:n]
        j = cols[s]
        low, up = valid & (j < ri), valid & (j > ri)
        got[ri[low], j[low]] = lv[s, :n][low]
        got[ri[up], j[up]] = uv[s, :n][up]
    got[ri, ri] = ud[:n]
    dense = a.to_dense()
    np.testing.assert_allclose(got, np.where(dense != 0, ikj_ilu0(dense),
                                             0.0), rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("problem,dt", CASES)
def test_ilu_apply_matches_jax(ops_, problem, dt):
    """``ilu_apply`` on the JAX factors (apply parity apart from factor
    parity), 3 sweeps and 3 inner sweeps."""
    o = ops_[problem, dt]
    lv, uv, ud = o["factors"]
    jl = dataclasses.replace(o["je"], vals=lv)
    ju = dataclasses.replace(o["je"], vals=uv)
    tl = dataclasses.replace(o["te"], vals=torch.from_numpy(np.array(lv)))
    tu = dataclasses.replace(o["te"], vals=torch.from_numpy(np.array(uv)))
    got = tsm.ilu_apply(o["th"], tl, tu, torch.from_numpy(np.array(ud)),
                        torch.from_numpy(o["b"]), torch.from_numpy(o["x"]),
                        3, 3)
    want = jsm.ilu_apply(o["jh"], jl, ju, ud, jnp.asarray(o["b"]),
                         jnp.asarray(o["x"]), 3, 3)
    close(got, want, DTYPES[dt][2])


def test_smoother_refusals(ops_):
    o = ops_["poisson32", "f64"]
    with pytest.raises(ValueError, match="unknown smoother kind"):
        tsm.make_smoother(o["th"], kind="ilut")
    with pytest.raises(ValueError, match="pure-ELL"):
        tsm.make_smoother(o["th"], kind="ilu0")


def test_gs2_triangular_spmv_is_one_k1_call(ops_, monkeypatch):
    """Each triangular SpMV of gs2 on a hybrid level is one K1 call (here
    its plain version): 2 sweeps × 2 halves × (1 + 2 inner) = 12."""
    o = ops_["csky10", "f32"]
    calls = []
    real = gather.hyb_spmv_plain
    monkeypatch.setattr(gather, "hyb_spmv_plain",
                        lambda *a: calls.append(1) or real(*a))
    sm = tsm.make_smoother(o["th"], kind="gs2")
    sm.apply(o["th"], torch.from_numpy(o["b"]), torch.from_numpy(o["x"]))
    assert len(calls) == 12


@pytest.mark.parametrize("agg", [2, 4])
@pytest.mark.parametrize("dt", list(DTYPES))
def test_galerkin_ell_bitwise(dt, agg):
    """Ac = PᵀAP for random aggregates of ``agg`` nodes (5 % of the nodes
    kept out) on poisson2d(32) with perturbed values, so that the order
    of each coarse entry's sum shows."""
    jdt, tdt, _ = DTYPES[dt]
    n = 32 * 32
    rs = np.random.RandomState(agg)
    lab = np.full(1024, -1, np.int32)
    lab[:n] = rs.permutation(n) // agg
    lab[:n][rs.rand(n) < 0.05] = -1
    nc = n // agg
    m = tgen.poisson2d(32).to_scipy()
    m.data = m.data * (1.0 + rs.rand(m.nnz))
    je = JCSR.from_scipy(m).to_ell(dtype=jdt)
    te = TCSR.from_scipy(m).to_ell(dtype=tdt, device="cpu")
    want = j_galerkin(je, jnp.asarray(lab), nc)
    got = galerkin_ell(te, torch.from_numpy(lab), nc)
    assert (got.nrows, got.npad, got.k) == (want.nrows, want.npad, want.k)
    for f in ("cols", "vals", "rownnz"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)))


@pytest.mark.parametrize("kind", ["gs2", "ilu0", "jacobi"])
def test_shard_hierarchy_refuses_other_smoothers(kind):
    """``shard_hierarchy`` takes every smoother kind the port has (their
    state sharded beside the level: the same preconditioner) and refuses
    only a kind it does not know."""
    a = tgen.poisson2d(16).to_ell(dtype=torch.float64, device="cpu")
    lab = torch.full((a.npad,), -1, dtype=torch.int32)
    lab[:256] = torch.arange(256, dtype=torch.int32) // 4
    ac = galerkin_ell(a, lab, 64)
    h = build_hierarchy(a, [lab], [ac], smoother_kind=kind)
    hs = shard_hierarchy(h, RowMesh(2, "cpu"))
    v = torch.from_numpy(np.random.RandomState(1).rand(a.npad))
    torch.testing.assert_close(hs.precondition(v), h.precondition(v),
                               rtol=1e-12, atol=1e-14)
    other = dataclasses.replace(h, levels=tuple(
        dataclasses.replace(lvl, smoother=dataclasses.replace(
            lvl.smoother, kind="sor")) for lvl in h.levels))
    with pytest.raises(NotImplementedError, match="smoother kinds"):
        shard_hierarchy(other, RowMesh(2, "cpu"))
