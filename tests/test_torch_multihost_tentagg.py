"""checktentagg on the row mesh over ranks, and the checked passes with
8×8 and 16×16 blocks, held to the JAX package.

One start of two ranks × two shards over gloo on the CPU (this file run
as a script, joined through the ``MGS_*`` variables, as
``tests/test_torch_multihost_breadth.py`` starts them) runs
``build_amg_setup_sharded`` with ``check_tentagg=True`` on

* poisson2d(64) f64, ``npass=2``, ``max_coarse_size=64`` (the settings
  of the JAX package's two-process harness with the check on): levels
  ``[4096, 1322, 399, 108, 27]``, labels bitwise the JAX package's
  one-process checked setup, the verdict log of every checked pass and
  the K-cycle count equal to the port's one-process run, and the bytes
  each checked call hands the transport;
* csky3d(20) f64 on the union route: labels bitwise the JAX package's.

The JAX references run in the test process while the ranks work.  In
one process: the Cholesky pivots of near-singular 8×8 and 16×16 blocks
bitwise LAPACK's ``spotrf`` as ``jnp.linalg.cholesky`` reaches it, and
the checked setups of poisson2d(64) and csky3d(10) with four passes
(pass 3 tests 8×8 blocks, pass 4 16×16): levels, labels and the
tentative and rejected pairs of every retry equal to the JAX package's.
The greedy matching and ``smooth_p`` stay refused over ranks.

Run alone with ``python -m pytest tests/test_torch_multihost_tentagg.py
-q -n 0``.
"""
import os
import socket
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from multigridsolver_tpu_torch import interop
from multigridsolver_tpu_torch.cli.generators import csky3d, poisson2d
from multigridsolver_tpu_torch.parallel import (RowMesh,
                                                build_amg_setup_sharded)
from multigridsolver_tpu_torch.setup import tentagg
from multigridsolver_tpu_torch.setup.aggregation import build_amg_setup
from multigridsolver_tpu_torch.solve.api import solve_hierarchy
from multigridsolver_tpu_torch.solve.hierarchy import build_hierarchy
from multigridsolver_tpu_torch.utils.config import (AggregationConfig,
                                                    BENCH_AGGREGATION,
                                                    CSKY_AGGREGATION,
                                                    HierarchyConfig)

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
RANKS = 2
SHARDS_PER_RANK = 2
SHARD_LEVELS = 2
GRID = 64
CSKY = 20
LEVELS = [4096, 1322, 399, 108, 27]
KCYCLE = dict(smoother_kind="chebyshev", cycle="kcycle", pre_smooth=1,
              post_smooth=1, kcycle_depth=3)
TOL = 1e-8
RANK_TIMEOUT_S = 150
# four passes with an early exit that never fires: passes 3 and 4 run
# checked (km 4 and 8, D = 8 and 16); a small tou ends the round after
# pass 1
DEEP = dict(npass=4, tou=1000.0, check_tentagg=True)
DEEP_CASES = {"poisson2d64": BENCH_AGGREGATION,
              "csky3d10": CSKY_AGGREGATION}
# one round (the finest level's): its passes 2-4 all run checked
DEEP_COARSE = {"poisson2d64": 1000, "csky3d10": 400}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def config(**agg) -> HierarchyConfig:
    return HierarchyConfig(max_coarse_size=64, aggregation=AggregationConfig(
        **{"npass": 2, "check_tentagg": True, **agg}))


def grid_ell():
    return poisson2d(GRID).to_ell(dtype=torch.float64, device="cpu")


def csky_ell():
    return csky3d(CSKY).to_ell(dtype=torch.float64, device="cpu",
                               with_transpose=True)


def rhs(n: int) -> np.ndarray:
    return np.random.RandomState(0).rand(n)


def verdict_log(setup) -> list:
    """Per round, per pass: None (unchecked) or the (pairs, rejected,
    near-zero) of each retry."""
    return [[None if p.checks is None else
             [(int(c["pairs"]), int(c["rejected"]), int(c["near_zero"]))
              for c in p.checks] for p in r.passes] for r in setup.rounds]


# ----------------------------------------------------------------- a rank

def rank_main(out_dir: str) -> None:
    from multigridsolver_tpu_torch.parallel import (
        gather_setup, global_row_mesh, init_multihost, shard_hierarchy,
        shutdown_multihost)
    torch.set_num_threads(1)
    comm = init_multihost(device="cpu")
    mesh = global_row_mesh(SHARDS_PER_RANK)
    sent = []
    plain = tentagg.checktentagg

    def counted(*args, **kw):
        before = sum(comm.sent.values())
        acc = plain(*args, **kw)
        sent.append(dict(bytes=sum(comm.sent.values()) - before,
                         ncp=args[4].shape[0], km=args[7],
                         sharded=args[0].shard is not None))
        return acc

    out = dict(rank=comm.rank)
    ell = grid_ell()
    agg_mod = sys.modules["multigridsolver_tpu_torch.setup.aggregation"]
    agg_mod.checktentagg = counted
    try:
        setup = build_amg_setup_sharded(ell, config(), mesh)
    finally:
        agg_mod.checktentagg = plain
    whole = gather_setup(setup, ell, mesh)
    hier = build_hierarchy(whole.matrices[0], whole.level_labels,
                           whole.matrices[1:], **KCYCLE)
    hs = shard_hierarchy(hier, mesh, shard_levels=SHARD_LEVELS)
    res = solve_hierarchy(hs, rhs(ell.nrows), tol=TOL)
    out["grid"] = dict(sizes=[m.nrows for m in whole.matrices],
                       labels=[l.numpy() for l in whole.level_labels],
                       log=verdict_log(setup), sent=sent,
                       iterations=res.iterations, status=res.status,
                       relres=res.relres)
    a = csky_ell()
    setup = build_amg_setup_sharded(a, config(**CSKY_AGGREGATION), mesh)
    whole = gather_setup(setup, a, mesh)
    out["csky"] = dict(halo=setup.matrices[0].shard[2],
                       sizes=[m.nrows for m in whole.matrices],
                       labels=[l.numpy() for l in whole.level_labels],
                       log=verdict_log(setup))
    torch.save(out, os.path.join(out_dir, f"rank{comm.rank}.pt"))
    shutdown_multihost()


# -------------------------------------------------------------- the tests

def jax_labels() -> dict:
    """The JAX package's one-process checked setups of both cases."""
    import jax.numpy as jnp
    from multigridsolver_tpu.cli import generators as jgen
    from multigridsolver_tpu.setup.aggregation import build_amg_setup as jset
    from multigridsolver_tpu.utils.config import (
        AggregationConfig as JAgg, HierarchyConfig as JHier)
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MGS_NO_WARMSET", "1")
        for name, a, agg in (
                ("grid", jgen.poisson2d(GRID).to_ell(dtype=jnp.float64), {}),
                ("csky", jgen.csky3d(CSKY).to_ell(dtype=jnp.float64,
                                                  with_transpose=True),
                 CSKY_AGGREGATION)):
            ref = jset(a, JHier(max_coarse_size=64, aggregation=JAgg(
                **{"npass": 2, "check_tentagg": True, **agg})))
            out[name] = dict(sizes=[m.nrows for m in ref.matrices],
                             labels=[np.asarray(l)
                                     for l in ref.level_labels])
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Both ranks' results from one start, and the JAX package's labels,
    computed while the ranks run."""
    out_dir = str(tmp_path_factory.mktemp("tentagg"))
    port = _free_port()
    procs = []
    for r in range(RANKS):
        env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1",
                   MGS_COORDINATOR=f"tcp://127.0.0.1:{port}",
                   MGS_NUM_PROCESSES=str(RANKS), MGS_PROCESS_ID=str(r))
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--rank", out_dir],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env,
            text=True))
    try:
        jax = jax_labels()
        outs = [p.communicate(timeout=RANK_TIMEOUT_S)[0] for p in procs]
    except BaseException:
        for p in procs:
            p.kill()
            p.communicate()
        raise
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{out[-4000:]}"
    return dict(jax=jax, ranks=[torch.load(os.path.join(out_dir,
                                                        f"rank{r}.pt"),
                                           weights_only=False)
                                for r in range(RANKS)])


@pytest.fixture(scope="module")
def grid_one():
    """The port's one-process checked setup of poisson2d(64) and its
    K-cycle count."""
    ell = grid_ell()
    s = build_amg_setup(ell, config())
    h = build_hierarchy(s.matrices[0], s.level_labels, s.matrices[1:],
                        **KCYCLE)
    return s, solve_hierarchy(h, rhs(ell.nrows), tol=TOL)


def assert_labels(got, want) -> None:
    assert len(got) == len(want)
    for lvl, (mine, ref) in enumerate(zip(got, want)):
        ref = np.asarray(ref)
        m = min(mine.shape[0], ref.shape[0])
        np.testing.assert_array_equal(mine[:m], ref[:m],
                                      err_msg=f"level {lvl}")
        assert (mine[m:] < 0).all() and (ref[m:] < 0).all()


def test_grid_over_ranks_labels_bitwise_jax(ranks):
    """poisson2d(64) f64 checked over 2 ranks × 2 shards: the JAX
    package's levels and labels (the check fired: unchecked, the levels
    are [4096, 1136, 309, 80, 17])."""
    assert ranks["jax"]["grid"]["sizes"] == LEVELS
    for r in ranks["ranks"]:
        assert r["grid"]["sizes"] == LEVELS
        assert_labels(r["grid"]["labels"], ranks["jax"]["grid"]["labels"])


def test_grid_over_ranks_verdicts_and_count_one_process(ranks, grid_one):
    """The verdict log of every pass equals the one-process run's (the
    checked branch taken exactly where one process takes it, the first
    round's with its merges summed over the ranks), and so does the
    K-cycle count on the sharded hierarchy."""
    s, want = grid_one
    log = verdict_log(s)
    assert log[0][1] is not None and log[0][1][0][1] > 0
    for r in ranks["ranks"]:
        got = r["grid"]
        assert got["log"] == log
        assert got["status"] == 0 and got["relres"] < TOL
        assert got["iterations"] == want.iterations


def test_grid_over_ranks_bytes_per_checked_call(ranks):
    """On the sharded level a checked call hands the transport the member
    counts and the verdicts (a byte per coarse node each) and the blocks
    of the merges that span the ranks: far less than the whole W; the
    calls on whole levels hand it nothing."""
    for r in ranks["ranks"]:
        calls = r["grid"]["sent"]
        sharded = [c for c in calls if c["sharded"]]
        assert len(sharded) == 3 and len(calls) > 3
        for c in sharded:
            d = 2 * c["km"]
            assert 2 * c["ncp"] < c["bytes"] < c["ncp"] * d * d * 4 // 8
        assert all(c["bytes"] == 0 for c in calls if not c["sharded"])


def test_csky_union_route_checked_labels_bitwise_jax(ranks):
    """csky3d(20) checked over ranks on the union route: the JAX
    package's labels; the checked passes where one process takes them."""
    one = build_amg_setup(csky_ell(), config(**CSKY_AGGREGATION))
    for r in ranks["ranks"]:
        got = r["csky"]
        assert got["halo"] is not None
        assert got["sizes"] == ranks["jax"]["csky"]["sizes"]
        assert_labels(got["labels"], ranks["jax"]["csky"]["labels"])
        assert [[p is None for p in rnd] for rnd in got["log"]] == \
            [[p is None for p in rnd] for rnd in verdict_log(one)]


@pytest.mark.parametrize("option", ["greedy", "smooth_p"])
def test_setup_over_ranks_still_refuses(option):
    """The greedy matching and smooth_p stay refused over ranks, with the
    reason; the refusal comes before any collective."""
    comm = types.SimpleNamespace(world=2, rank=0)
    mesh = RowMesh(4, "cpu", comm=comm)
    cfg = {"greedy": HierarchyConfig(aggregation=AggregationConfig(
        matching="greedy", check_tentagg=True)),
        "smooth_p": HierarchyConfig(smooth_p=2.0 / 3.0)}[option]
    why = {"greedy": "reads the whole finest level on the host",
           "smooth_p": "SpGEMM reads host sizes"}[option]
    with pytest.raises(NotImplementedError, match=why):
        build_amg_setup_sharded(grid_ell(), cfg, mesh)


# ------------------------------------------- the checked passes 3 and 4

@pytest.mark.parametrize("d", [8, 16])
def test_cholesky_pivots_bitwise_spotrf(d):
    """Near-singular float32 blocks (rank d−1 Gram matrices plus a small
    shift): every pivot's root bitwise the diagonal of
    ``jnp.linalg.cholesky`` (LAPACK's spotrf), and the same verdicts."""
    import jax
    import jax.numpy as jnp
    rs = np.random.RandomState(d)
    x = rs.randn(2000, d, d - 1).astype(np.float32)
    w = np.einsum("bik,bjk->bij", x, x).astype(np.float32)
    w += (rs.rand(2000, 1, 1).astype(np.float32) * 1e-5) \
        * np.eye(d, dtype=np.float32)
    w = ((w + w.transpose(0, 2, 1)) / 2).astype(np.float32)
    chol = np.asarray(jax.jit(jnp.linalg.cholesky)(jnp.asarray(w)))
    diag = np.einsum("bjj->bj", chol)
    piv = tentagg.cholesky_pivots(torch.from_numpy(w)).numpy()
    ok_j = np.isfinite(diag).all(1) & (np.nan_to_num(diag) > 0).all(1)
    ok_t = ((piv > 0) & np.isfinite(piv)).all(1)
    np.testing.assert_array_equal(ok_t, ok_j)
    assert 0 < (~ok_j).sum() < 200
    with np.errstate(invalid="ignore"):
        root = np.sqrt(piv[ok_t].astype(np.float64)).astype(np.float32)
    np.testing.assert_array_equal(root.view(np.uint32),
                                  diag[ok_j].view(np.uint32))


def jax_deep(name: str):
    """The JAX package's checked setup of a DEEP case and its verdict log
    ((km, pairs, rejected) per retry), read as
    ``tools/quality_anchor_jax.py`` reads it."""
    import jax
    import jax.numpy as jnp
    from multigridsolver_tpu.cli import generators as jgen
    from multigridsolver_tpu.setup import aggregation as jagg
    from multigridsolver_tpu.setup import tentagg as jtg
    from multigridsolver_tpu.utils.config import (
        AggregationConfig as JAgg, HierarchyConfig as JHier)
    a = (jgen.poisson2d(GRID).to_ell(dtype=jnp.float32)
         if name == "poisson2d64" else
         jgen.csky3d(10).to_ell(dtype=jnp.float32, with_transpose=True))
    log = []
    orig = jtg.checktentagg

    def logged(a0, si0, labels, ac, paired, ktg, zerors, km):
        acc = orig(a0, si0, labels, ac, paired, ktg, zerors, km)
        cn = jnp.arange(paired.shape[0], dtype=jnp.int32)
        lead = (paired >= 0) & (paired > cn)
        jax.debug.callback(lambda p, r: log.append((km, int(p), int(r))),
                           jnp.sum(lead), jnp.sum(lead & ~acc), ordered=True)
        return acc
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MGS_NO_WARMSET", "1")
        mp.setattr(jtg, "checktentagg", logged)
        jagg._match_pass_checked.clear_cache()
        try:
            s = jagg.build_amg_setup(a, JHier(
                max_coarse_size=DEEP_COARSE[name],
                aggregation=JAgg(**{**DEEP_CASES[name], **DEEP})))
        finally:
            jagg._match_pass_checked.clear_cache()
    return a, s, log


@pytest.mark.parametrize("name", list(DEEP_CASES))
def test_checked_passes_3_and_4_bitwise_jax(name):
    """Four checked passes: levels, labels and every retry's tentative and
    rejected pairs equal to the JAX package's; passes 3 (D = 8) and 4
    (D = 16) ran checked and rejected pairs."""
    ja, js, jlog = jax_deep(name)
    a = interop.ell_from_numpy(
        np.asarray(ja.cols), np.asarray(ja.vals), np.asarray(ja.rownnz),
        ja.nrows, ja.ncols, device="cpu",
        vals_t=None if ja.vals_t is None else np.asarray(ja.vals_t))
    ts = build_amg_setup(a, HierarchyConfig(
        max_coarse_size=DEEP_COARSE[name], aggregation=AggregationConfig(
            **{**DEEP_CASES[name], **DEEP})))
    assert [m.nrows for m in ts.matrices] == [m.nrows for m in js.matrices]
    assert_labels([l.numpy() for l in ts.level_labels], js.level_labels)
    tlog = [(2 ** s, int(c["pairs"]), int(c["rejected"]))
            for r in ts.rounds for s, p in enumerate(r.passes)
            if p.checks for c in p.checks]
    assert tlog == jlog
    for km in (4, 8):
        assert sum(rej for k, _, rej in tlog if k == km) > 0, km


if __name__ == "__main__":
    # python tests/test_torch_multihost_tentagg.py --rank OUT_DIR
    mode, out_dir = sys.argv[1:3]
    if mode != "--rank":
        sys.exit(f"unknown mode {mode}")
    rank_main(out_dir)
