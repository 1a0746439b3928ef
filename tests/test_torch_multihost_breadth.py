"""The row mesh over ranks beyond the main path: two processes joined over
gloo on the CPU, 2 ranks × 2 shards, held to one process and to the JAX
package.

One start of two ranks (this file run as a script, joined through the
``MGS_*`` variables, as ``tests/test_torch_multihost.py`` starts them)
runs, on a mesh whose sharded levels span both ranks:

* poisson2d(64) with each smoother kind but Chebyshev (jacobi, l1jacobi,
  gs2, ilu0) on a K-cycle with the two finest levels sharded: gs2's
  triangular halves and ilu0's L and U bound to the mesh beside the
  level.  Held to the port's one-process unsharded run: the iteration
  count, and one preconditioner application to rtol 1e-10;
* csky3d(20) on the union route (the transposed-value field through the
  row halo and K3's fourth source): labels bitwise the JAX package's
  one-process setup, the count the port's one-process run;
* poisson2d(64) under one symmetric random permutation
  (``RandomState(0)``): the finest level's halo exceeds a shard, so its
  setup gathers and its SpMVs read the all-gathered field.  Labels
  bitwise the unsharded run's, the same count;
* the three routes of an operator bound to the mesh one by one: a plain
  ELL on the index-list exchange and on the all-gather route, and a
  hybrid whose lanes reach past a shard (its halo from the all-gathered
  x), each equal to the whole operator's SpMV on the rank's rows;
* ``check_replicated`` on a hierarchy one of whose ranks holds ilu0
  factors that differ in one bit: both ranks refuse it.

A second start, of four ranks × one shard at the same time, runs the
permuted poisson2d(64) with ilu0 and its finest level alone sharded:
there aggregates reach past the next rank, so the restriction reads the
whole vector, all-gathered, and the plain-ELL L and U take the
all-gather route.  Held to one process: the restriction bitwise, labels
bitwise, the same count.

The JAX reference runs in the test process while the ranks work.  Run
alone with ``python -m pytest tests/test_torch_multihost_breadth.py -q
-n 0``.
"""
import os
import socket
import subprocess
import sys
from unittest import mock

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from multigridsolver_tpu_torch.cli.generators import csky3d, poisson2d
from multigridsolver_tpu_torch.ops import gather as g
from multigridsolver_tpu_torch.parallel import RowMesh, shard_hierarchy
from multigridsolver_tpu_torch.setup import transfers as tf
from multigridsolver_tpu_torch.setup.aggregation import build_amg_setup
from multigridsolver_tpu_torch.solve.api import pad_vector, solve_hierarchy
from multigridsolver_tpu_torch.solve.hierarchy import build_hierarchy
from multigridsolver_tpu_torch.sparse import hybrid as hyb
from multigridsolver_tpu_torch.sparse.formats import CSR
from multigridsolver_tpu_torch.utils.config import (AggregationConfig,
                                                    CSKY_AGGREGATION,
                                                    HierarchyConfig)

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
RANKS = 2
# the second start: four ranks of one shard each
GATHERED_RANKS = 4
GRID = 64
CSKY = 20
SHARDS_PER_RANK = 2
SHARD_LEVELS = 2
KINDS = ("jacobi", "l1jacobi", "gs2", "ilu0")
KCYCLE = dict(cycle="kcycle", pre_smooth=1, post_smooth=1, kcycle_depth=3)
TOL = 1e-8
RANK_TIMEOUT_S = 150
# a banded operator whose lanes reach past a shard of 1024 rows
FAR = 1500


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def config(**agg) -> HierarchyConfig:
    return HierarchyConfig(max_coarse_size=64,
                           aggregation=AggregationConfig(**{"npass": 2,
                                                            **agg}))


def rhs(n: int) -> np.ndarray:
    return np.random.RandomState(0).rand(n)


def probe(n: int, seed: int = 5) -> np.ndarray:
    return np.random.RandomState(seed).rand(n)


def grid_ell():
    return poisson2d(GRID).to_ell(dtype=torch.float64, device="cpu")


def permuted_ell():
    """poisson2d(64) under one symmetric random permutation."""
    m = poisson2d(GRID).to_scipy()
    p = np.random.RandomState(0).permutation(m.shape[0])
    return CSR.from_scipy(m[p][:, p].tocsr()).to_ell(dtype=torch.float64,
                                                     device="cpu")


def csky_ell():
    return csky3d(CSKY).to_ell(dtype=torch.float64, device="cpu",
                               with_transpose=True)


def far_ell():
    """A symmetric banded operator with lanes at ±1, ±64 and ±FAR."""
    n = GRID * GRID
    offs = (-FAR, -GRID, -1, 0, 1, GRID, FAR)
    rs = np.random.RandomState(9)
    m = sp.diags([rs.rand(n - abs(o)) + (4.0 if o == 0 else 0.0)
                  for o in offs], offs, format="csr")
    return CSR.from_scipy(m).to_ell(dtype=torch.float64, device="cpu")


# ----------------------------------------------------------------- a rank

def smoother_runs(mesh, out) -> None:
    """poisson2d(64), every smoother kind on two sharded levels."""
    from multigridsolver_tpu_torch.parallel import (
        build_amg_setup_sharded, check_replicated, gather_setup, host_read,
        put_global, shard_hierarchy)
    from multigridsolver_tpu_torch.parallel.halo import spmv_route
    ell = grid_ell()
    whole = gather_setup(build_amg_setup_sharded(ell, config(), mesh), ell,
                         mesh)
    for kind in KINDS:
        hier = build_hierarchy(whole.matrices[0], whole.level_labels,
                               whole.matrices[1:], smoother_kind=kind,
                               **KCYCLE)
        hs = shard_hierarchy(hier, mesh, shard_levels=SHARD_LEVELS)
        res = solve_hierarchy(hs, rhs(ell.nrows), tol=TOL)
        npad = hs.levels[0].a.npad * mesh.world
        v = put_global(pad_vector(probe(ell.nrows), npad, torch.float64,
                                  "cpu"), mesh)
        sm = [lvl.smoother for lvl in hs.levels[:SHARD_LEVELS]]
        out[kind] = dict(
            iterations=res.iterations, status=res.status, relres=res.relres,
            digest=check_replicated(hs, mesh, SHARD_LEVELS),
            pre=host_read(hs.precondition(v), mesh)[:ell.nrows],
            labels=[l.numpy() for l in whole.level_labels],
            routes=[spmv_route(lvl.a) for lvl in hs.levels[:SHARD_LEVELS]],
            state_routes=[[spmv_route(op) for op in (s.lower, s.upper,
                                                     s.lmat, s.umat)
                           if op is not None] for s in sm],
            state_types=[[type(op).__name__ for op in (s.lower, s.upper,
                                                       s.lmat, s.umat)
                          if op is not None] for s in sm])


def setup_run(ell, mesh, cfg, **hier_kw) -> dict:
    """A sharded setup over the ranks, its hierarchy and solve."""
    from multigridsolver_tpu_torch.parallel import (
        build_amg_setup_sharded, gather_setup, shard_hierarchy)
    from multigridsolver_tpu_torch.parallel.halo import spmv_route
    setup = build_amg_setup_sharded(ell, cfg, mesh)
    whole = gather_setup(setup, ell, mesh)
    hier = build_hierarchy(whole.matrices[0], whole.level_labels,
                           whole.matrices[1:], **hier_kw)
    hs = shard_hierarchy(hier, mesh, shard_levels=SHARD_LEVELS)
    res = solve_hierarchy(hs, rhs(ell.nrows), tol=TOL)
    return dict(labels=[l.numpy() for l in whole.level_labels],
                sizes=[m.nrows for m in whole.matrices],
                halo=setup.matrices[0].shard[2],
                iterations=res.iterations, status=res.status,
                relres=res.relres,
                routes=[spmv_route(lvl.a)
                        for lvl in hs.levels[:SHARD_LEVELS]],
                reach=[(lvl.tplan.reach, lvl.tplan.npad_f,
                        lvl.tplan.gathered)
                       for lvl in hs.levels[:SHARD_LEVELS]])


def bound_spmvs(mesh) -> dict:
    """Each operator bound to the mesh alone, its SpMV on a probe."""
    from multigridsolver_tpu_torch.parallel import put_global
    from multigridsolver_tpu_torch.parallel.halo import (bind_operator,
                                                         spmv_route)
    from multigridsolver_tpu_torch.parallel.sharded import repad_operator
    out = {}
    for name, op in (("exchange", grid_ell()), ("all_gather", permuted_ell()),
                     ("far", hyb.hybrid_from_ell(far_ell()))):
        op = repad_operator(op, mesh)
        bound = bind_operator(op, mesh)
        x = put_global(probe(op.npad, 6), mesh)
        with mock.patch.object(g, "hyb_spmv_sharded",
                               wraps=g.hyb_spmv_sharded) as k1:
            y = bound.spmv(x)
        out[name] = dict(route=spmv_route(bound), y=y,
                         rows=mesh.local_rows(op.npad),
                         launches=k1.call_count)
    return out


def flipped_digest(mesh) -> str:
    """``check_replicated`` of an ilu0 hierarchy (one sharded level) whose
    level-1 L factor differs in one bit on rank 1: the refusal's text."""
    import dataclasses
    from multigridsolver_tpu_torch.parallel import (check_replicated,
                                                    shard_hierarchy)
    ell = grid_ell()
    s = build_amg_setup(ell, config())
    hier = build_hierarchy(s.matrices[0], s.level_labels, s.matrices[1:],
                           smoother_kind="ilu0", **KCYCLE)
    hs = shard_hierarchy(hier, mesh, shard_levels=1)
    if mesh.rank == 1:
        lvl = hs.levels[1]
        vals = lvl.smoother.lmat.vals.clone()
        k, i = (v[0] for v in torch.nonzero(vals, as_tuple=True))
        vals.view(torch.int64)[k, i] ^= 1
        sm = dataclasses.replace(lvl.smoother, lmat=dataclasses.replace(
            lvl.smoother.lmat, vals=vals))
        hs = dataclasses.replace(hs, levels=(
            hs.levels[0], dataclasses.replace(lvl, smoother=sm),
            *hs.levels[2:]))
    try:
        check_replicated(hs, mesh, 1)
    except RuntimeError as e:
        return str(e)
    return ""


def gathered_main(out_dir: str) -> None:
    """One of four ranks × one shard: the permuted poisson2d(64) through
    the entry points with ilu0, its finest level alone sharded; the
    restriction of a probe and the solve."""
    from multigridsolver_tpu_torch.parallel import (
        build_amg_setup_sharded, gather_setup, global_row_mesh,
        init_multihost, shutdown_multihost)
    from multigridsolver_tpu_torch.parallel.halo import spmv_route
    torch.set_num_threads(1)
    comm = init_multihost(device="cpu")
    mesh = global_row_mesh(1)
    ell = permuted_ell()
    whole = gather_setup(build_amg_setup_sharded(ell, config(), mesh), ell,
                         mesh)
    hier = build_hierarchy(whole.matrices[0], whole.level_labels,
                           whole.matrices[1:], smoother_kind="ilu0",
                           **KCYCLE)
    hs = shard_hierarchy(hier, mesh, shard_levels=1)
    res = solve_hierarchy(hs, rhs(ell.nrows), tol=TOL)
    tp = hs.levels[0].tplan
    v = torch.from_numpy(probe(hs.levels[0].a.npad * mesh.world, 7))
    lo, hi = mesh.local_rows(v.shape[0])
    sm = hs.levels[0].smoother
    torch.save(dict(
        labels=[l.numpy() for l in whole.level_labels],
        iterations=res.iterations, status=res.status, relres=res.relres,
        reach=tp.reach, rows=tp.npad_f, gathered=tp.gathered,
        restricted=tf.restrict_fast(tp, v[lo:hi]),
        state_routes=[spmv_route(op) for op in (sm.lmat, sm.umat)]),
        os.path.join(out_dir, f"gathered{comm.rank}.pt"))
    shutdown_multihost()


def rank_main(out_dir: str) -> None:
    from multigridsolver_tpu_torch.parallel import (global_row_mesh,
                                                    init_multihost,
                                                    shutdown_multihost)
    torch.set_num_threads(1)
    comm = init_multihost(device="cpu")
    mesh = global_row_mesh(SHARDS_PER_RANK)
    out = dict(rank=comm.rank, smoothers={})
    smoother_runs(mesh, out["smoothers"])
    out["csky"] = setup_run(csky_ell(), mesh, config(**CSKY_AGGREGATION),
                            smoother_kind="chebyshev", **KCYCLE)
    out["permuted"] = setup_run(permuted_ell(), mesh, config(),
                                smoother_kind="chebyshev", **KCYCLE)
    out["bound"] = bound_spmvs(mesh)
    out["flipped"] = flipped_digest(mesh)
    torch.save(out, os.path.join(out_dir, f"rank{comm.rank}.pt"))
    shutdown_multihost()


# -------------------------------------------------------------- the tests

def jax_csky_labels() -> list:
    """The JAX package's one-process setup of the csky3d(20) case."""
    import jax.numpy as jnp
    from multigridsolver_tpu.cli import generators as jgen
    from multigridsolver_tpu.setup.aggregation import build_amg_setup as jset
    from multigridsolver_tpu.utils.config import (
        AggregationConfig as JAgg, HierarchyConfig as JHier)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MGS_NO_WARMSET", "1")
        a = jgen.csky3d(CSKY).to_ell(dtype=jnp.float64, with_transpose=True)
        ref = jset(a, JHier(max_coarse_size=64,
                            aggregation=JAgg(**CSKY_AGGREGATION)))
        return [np.asarray(l) for l in ref.level_labels]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Both ranks' results from one start, the four ranks' of the
    second, and the JAX package's csky labels, computed while the ranks
    run."""
    out_dir = str(tmp_path_factory.mktemp("breadth"))
    procs = []
    for mode, world in (("--rank", RANKS), ("--gathered", GATHERED_RANKS)):
        port = _free_port()
        for r in range(world):
            env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1",
                       MGS_COORDINATOR=f"tcp://127.0.0.1:{port}",
                       MGS_NUM_PROCESSES=str(world), MGS_PROCESS_ID=str(r))
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), mode, out_dir],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env,
                text=True))
    try:
        jax_labels = jax_csky_labels()
        outs = [p.communicate(timeout=RANK_TIMEOUT_S)[0] for p in procs]
    except BaseException:
        for p in procs:
            p.kill()
            p.communicate()
        raise
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{out[-4000:]}"
    def load(name):
        return torch.load(os.path.join(out_dir, name), weights_only=False)
    return dict(jax_csky=jax_labels,
                ranks=[load(f"rank{r}.pt") for r in range(RANKS)],
                gathered=[load(f"gathered{r}.pt")
                          for r in range(GATHERED_RANKS)])


def one_process(ell, cfg, **hier_kw):
    s = build_amg_setup(ell, cfg)
    h = build_hierarchy(s.matrices[0], s.level_labels, s.matrices[1:],
                        **hier_kw)
    return s, h, solve_hierarchy(h, rhs(ell.nrows), tol=TOL)


@pytest.fixture(scope="module")
def grid_one():
    """The port's one-process unsharded setup of poisson2d(64)."""
    return build_amg_setup(grid_ell(), config())


def assert_labels(got, want) -> None:
    assert len(got) == len(want)
    for lvl, (mine, ref) in enumerate(zip(got, want)):
        ref = np.asarray(ref)
        m = min(mine.shape[0], ref.shape[0])
        np.testing.assert_array_equal(mine[:m], ref[:m],
                                      err_msg=f"level {lvl}")
        assert (mine[m:] < 0).all() and (ref[m:] < 0).all()


@pytest.mark.parametrize("kind", KINDS)
def test_smoother_kind_matches_one_process(ranks, grid_one, kind):
    """Each kind's sharded K-cycle over ranks: the unsharded count, the
    same preconditioner, one replicated digest on both ranks."""
    ell = grid_ell()
    h = build_hierarchy(grid_one.matrices[0], grid_one.level_labels,
                        grid_one.matrices[1:], smoother_kind=kind, **KCYCLE)
    want = solve_hierarchy(h, rhs(ell.nrows), tol=TOL)
    pre = h.precondition(pad_vector(probe(ell.nrows), h.levels[0].a.npad,
                                    torch.float64, "cpu")).numpy()
    got = [r["smoothers"][kind] for r in ranks["ranks"]]
    for r in got:
        assert r["status"] == 0 and r["relres"] < TOL
        assert r["iterations"] == want.iterations
        assert_labels(r["labels"], [l.numpy() for l in
                                    grid_one.level_labels])
        np.testing.assert_allclose(r["pre"], pre[:ell.nrows], rtol=1e-10,
                                   atol=1e-12 * float(np.abs(pre).max()))
    assert got[0]["digest"] == got[1]["digest"]
    np.testing.assert_array_equal(got[0]["pre"], got[1]["pre"])


@pytest.mark.parametrize("kind", ["gs2", "ilu0"])
def test_smoother_state_bound_to_the_mesh(ranks, kind):
    """gs2's halves ride the halo (level 0 pure DIA, level 1 its
    remainder on the exchange); ilu0's L and U are ExchangeELLs on the
    index-list exchange."""
    want = {"gs2": [["HaloOp", "HaloOp"]] * SHARD_LEVELS,
            "ilu0": [["ExchangeELL", "ExchangeELL"]] * SHARD_LEVELS}[kind]
    for r in ranks["ranks"]:
        got = r["smoothers"][kind]
        assert got["state_types"] == want
        assert got["routes"] == ["none", "exchange"]
        if kind == "ilu0":
            assert got["state_routes"] == [["exchange"] * 2] * SHARD_LEVELS


def test_union_route_labels_bitwise_jax(ranks):
    """csky3d(20) over ranks, the transposed-value field through the row
    halo and K3's fourth source: the JAX package's one-process labels."""
    for r in ranks["ranks"]:
        got = r["csky"]
        assert got["halo"] is not None
        assert_labels(got["labels"], ranks["jax_csky"])


def test_union_route_solve_matches_one_process(ranks):
    s, _, want = one_process(csky_ell(), config(**CSKY_AGGREGATION),
                             smoother_kind="chebyshev", **KCYCLE)
    for r in ranks["ranks"]:
        got = r["csky"]
        assert got["sizes"] == [m.nrows for m in s.matrices]
        assert got["status"] == 0 and got["relres"] < TOL
        assert got["iterations"] == want.iterations


def test_permuted_grid_takes_the_all_gather_route(ranks):
    """The permuted grid's finest halo exceeds a shard: its setup gathers
    read the whole field and its SpMVs the all-gathered x; its aggregates
    reach into the next rank (over two ranks never past it, so the
    restriction reads the whole vector only from three ranks on).  Labels
    bitwise and the count of the unsharded run."""
    s, _, want = one_process(permuted_ell(), config(),
                             smoother_kind="chebyshev", **KCYCLE)
    for r in ranks["ranks"]:
        got = r["permuted"]
        assert got["halo"] is None
        assert got["routes"][0] == "all_gather"
        reach, per_rank, gathered = got["reach"][0]
        assert 0 < reach <= per_rank and not gathered
        assert_labels(got["labels"], [l.numpy() for l in s.level_labels])
        assert got["status"] == 0 and got["relres"] < TOL
        assert got["iterations"] == want.iterations


@pytest.mark.parametrize("name,route", [("exchange", "exchange"),
                                        ("all_gather", "all_gather"),
                                        ("far", "all_gather")])
def test_bound_operator_matches_whole_spmv(ranks, name, route):
    """A plain ELL on the exchange and on the all-gather route, and a
    hybrid whose lanes reach past a shard: one sharded launch each, equal
    to the whole operator's SpMV on the rank's rows."""
    op = {"exchange": grid_ell, "all_gather": permuted_ell,
          "far": far_ell}[name]()
    for r in ranks["ranks"]:
        got = r["bound"][name]
        assert got["route"] == route and got["launches"] == 1
        lo, hi = got["rows"]
        x = probe(got["y"].shape[0] * RANKS, 6)
        y = op.to_csr().to_scipy() @ x[:op.ncols]
        mine = np.arange(lo, hi)
        keep = mine < op.nrows
        np.testing.assert_allclose(got["y"].numpy()[keep], y[mine[keep]],
                                   rtol=1e-12, atol=1e-12)


def test_check_replicated_refuses_one_flipped_factor_bit(ranks):
    for r in ranks["ranks"]:
        assert "replicated levels differ" in r["flipped"]


@pytest.fixture(scope="module")
def permuted_ilu0():
    """The port's one-process setup and ilu0 solve of the permuted grid."""
    return one_process(permuted_ell(), config(), smoother_kind="ilu0",
                       **KCYCLE)


def test_restriction_reads_the_whole_vector_past_the_next_rank(
        ranks, permuted_ilu0):
    """Over four ranks the permuted grid's aggregates reach past the next
    rank: each rank restricts from the all-gathered vector, bitwise the
    one-process K1 restriction."""
    _, h, _ = permuted_ilu0
    hs = shard_hierarchy(h, RowMesh(GATHERED_RANKS, "cpu"), shard_levels=1)
    want = tf.restrict_fast(hs.levels[0].tplan, torch.from_numpy(
        probe(hs.levels[0].a.npad, 7)))
    for r in ranks["gathered"]:
        assert r["gathered"] and r["reach"] > r["rows"]
        assert torch.equal(r["restricted"], want)


def test_plain_ell_factors_on_the_all_gather_route(ranks, permuted_ilu0):
    """ilu0's L and U of the permuted finest level, plain ELLs whose
    exchange plans are refused, take the all-gather route over four
    ranks: labels bitwise and the one-process count."""
    s, _, want = permuted_ilu0
    for r in ranks["gathered"]:
        assert r["state_routes"] == ["all_gather", "all_gather"]
        assert_labels(r["labels"], [l.numpy() for l in s.level_labels])
        assert r["status"] == 0 and r["relres"] < TOL
        assert r["iterations"] == want.iterations


if __name__ == "__main__":
    # python tests/test_torch_multihost_breadth.py --rank|--gathered OUT_DIR
    mode, out_dir = sys.argv[1:3]
    if mode not in ("--rank", "--gathered"):
        sys.exit(f"unknown mode {mode}")
    (rank_main if mode == "--rank" else gathered_main)(out_dir)
