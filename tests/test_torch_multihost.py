"""The row mesh over ranks (``parallel/multihost.py``): two processes
joined over gloo on the CPU, held to the JAX package's one-process run.

The problem is the JAX package's own two-process worker's
(``tests/multihost_worker.py``): poisson2d(24), ``max_coarse_size=64``,
``npass=2``, float64, a Chebyshev V-cycle, BiCGStab to 1e-8 and
``b = RandomState(0).rand``.  One start of two ranks (this file run as a
script, each rank importing only torch and the port, joined through the
``MGS_*`` environment variables) runs every layout: 2 ranks × 1 shard and
2 ranks × 2 shards, each with the finest one and two levels sharded.  The
ranks save what they computed; the tests hold it to

* the JAX package's one-process setup: labels on every level, bitwise;
* the JAX package's one-process solve: the same iteration count;
* the port's one-process solve: x within rtol 1e-9, atol 1e-12;
* the port's one-process sharded hierarchy: the restriction, bitwise;
* the one-process ``RowMesh``: the four collectives.

Run it alone with ``python -m pytest tests/test_torch_multihost.py -q
-n 0``; the test needing a card (NCCL refusing two ranks on one card)
runs on the card's machine with ``--noconftest -o addopts="" -m cuda``.
"""
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from multigridsolver_tpu_torch.cli.generators import poisson2d
from multigridsolver_tpu_torch.parallel import (RowMesh, init_multihost,
                                                shard_hierarchy,
                                                shard_operator)
from multigridsolver_tpu_torch.setup import transfers as tf
from multigridsolver_tpu_torch.setup.aggregation import build_amg_setup
from multigridsolver_tpu_torch.solve.api import solve_hierarchy
from multigridsolver_tpu_torch.solve.hierarchy import build_hierarchy
from multigridsolver_tpu_torch.sparse.hybrid import hybrid_from_ell
from multigridsolver_tpu_torch.utils.config import (AggregationConfig,
                                                    HierarchyConfig)

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
GRID = 24
# the finest level's setup shards hold whole blocks of 1024 rows, so
# poisson2d(24)'s 576 rows all lie on rank 0 there (its solve crosses the
# ranks); poisson2d(64)'s 4096 rows put the setup on both ranks
WIDE = 64
RANKS = 2
LAYOUTS = [(spr, sl) for spr in (1, 2) for sl in (1, 2)]
# (grid, shards a rank, numbers of sharded levels) the ranks run
LAYOUT_RUNS = [(GRID, 1, (1, 2)), (GRID, 2, (1, 2)), (WIDE, 1, (2,)),
               (WIDE, 2, (2,))]
TOL = 1e-8
# each start and join of the ranks is bounded (pytest-timeout is absent)
RANK_TIMEOUT_S = 120
HALO_H = 8
EXCHANGE_L = 5


def config(**agg) -> HierarchyConfig:
    return HierarchyConfig(max_coarse_size=64,
                           aggregation=AggregationConfig(npass=2, **agg))


# skipass fires on poisson2d(64): its G0-excluded boundary rows are 6 %
SKIPASS = dict(skipass_frac=0.05)


def wide_ell(grid: int):
    return poisson2d(grid).to_ell(dtype=torch.float64, device="cpu")


def rhs(n: int) -> np.ndarray:
    return np.random.RandomState(0).rand(n)


def collective_inputs(ndev: int, npr: int):
    """Whole inputs of the collectives, the same on every rank."""
    rs = np.random.RandomState(7)
    x = torch.from_numpy(rs.rand(ndev * npr))
    flags = torch.from_numpy(rs.rand(ndev * npr) < 0.5)
    blocks = torch.from_numpy(rs.rand(ndev, ndev, EXCHANGE_L))
    parts = torch.from_numpy(rs.rand(ndev, 3))
    return x, flags, blocks, parts


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# ----------------------------------------------------------------- a rank

def run_layouts(ell, spr: int, sls, out: dict, key) -> None:
    """The sharded setup, hierarchy, solve and restriction of ``ell`` on
    a mesh of ``spr`` shards a rank, for each number of sharded levels in
    ``sls``; results under ``out[(*key, spr, sl)]``."""
    from multigridsolver_tpu_torch.parallel import (
        build_amg_setup_sharded, check_replicated, gather_setup,
        global_row_mesh, host_read)
    mesh = global_row_mesh(spr)
    b = rhs(ell.nrows)
    setup = build_amg_setup_sharded(ell, config(), mesh)
    whole = gather_setup(setup, ell, mesh)
    hier = build_hierarchy(whole.matrices[0], whole.level_labels,
                           whole.matrices[1:], smoother_kind="chebyshev",
                           cycle="vcycle")
    for sl in sls:
        hs = shard_hierarchy(hier, mesh, shard_levels=sl)
        digest = check_replicated(hs, mesh, sl)
        res = solve_hierarchy(hs, b, tol=TOL)
        restricted = []
        for lvl in range(sl):
            v = torch.from_numpy(np.random.RandomState(5 + lvl).rand(
                hs.levels[lvl].a.npad * mesh.world))
            lo, hi = mesh.local_rows(v.shape[0])
            rc = tf.restrict_fast(hs.levels[lvl].tplan, v[lo:hi])
            restricted.append(host_read(rc, mesh if lvl + 1 < sl else None))
        out[(*key, spr, sl)] = dict(
            labels=[l.numpy() for l in whole.level_labels],
            sizes=[m.nrows for m in whole.matrices],
            rows0=setup.matrices[0].npad, iterations=res.iterations,
            status=res.status, relres=res.relres,
            x=host_read(res.x, mesh)[:ell.nrows], restricted=restricted,
            digest=digest, routes=[type(l.a).__name__ for l in hs.levels])


def rank_main(out_dir: str) -> None:
    """One rank: joins through the environment, runs every layout, saves
    its results to ``out_dir/rank<r>.pt``."""
    from multigridsolver_tpu_torch.parallel import (
        build_amg_setup_sharded, gather_setup, global_row_mesh, put_global,
        shard_vector, shutdown_multihost)
    torch.set_num_threads(1)
    comm = init_multihost(device="cpu")
    out = dict(rank=comm.rank, world=comm.world, backend=comm.backend,
               layouts={}, collectives={})
    for grid, spr, sls in LAYOUT_RUNS:
        run_layouts(wide_ell(grid), spr, sls, out["layouts"], (grid,))
    for spr in (1, 2):
        mesh = global_row_mesh(spr)
        ndev = mesh.ndev
        x, flags, blocks, parts = collective_inputs(ndev, 4 * HALO_H)
        lo, hi = mesh.local_rows(x.shape[0])
        mine = slice(mesh.first_shard, mesh.first_shard + mesh.nlocal)
        out["collectives"][spr] = dict(
            halo=mesh.boundary_halo(x[lo:hi], HALO_H),
            bool_halo=mesh.boundary_halo(flags[lo:hi], HALO_H),
            all_to_all=mesh.all_to_all(blocks[mine].contiguous()),
            all_gather=mesh.all_gather(parts[mine]),
            sum=mesh.allreduce_sum(x[lo:hi].sum()),
            max=mesh.allreduce_max(x[lo:hi].max()),
            any=mesh.allreduce_max(flags[lo:hi][:1].clone()),
            dot=mesh.dot(x[lo:hi], x[lo:hi]))
    mesh = global_row_mesh(2)
    ell = wide_ell(WIDE)
    skip = gather_setup(build_amg_setup_sharded(ell, config(**SKIPASS),
                                                mesh), ell, mesh)
    out["skipass"] = [l.numpy() for l in skip.level_labels]
    v = torch.from_numpy(np.random.RandomState(8).rand(ell.npad))
    op = shard_operator(ell, mesh)
    out["shard"] = dict(put_global=put_global(v.numpy(), mesh),
                        shard_vector=shard_vector(v, mesh),
                        cols=op.cols, vals=op.vals, rownnz=op.rownnz,
                        marker=op.shard[1:], row0=op.row0,
                        dvals=shard_operator(hybrid_from_ell(ell),
                                             mesh).dvals)
    out["sent"] = dict(comm.sent)
    torch.save(out, os.path.join(out_dir, f"rank{comm.rank}.pt"))
    shutdown_multihost()


def nccl_shared_main() -> None:
    """One rank of an NCCL group whose two ranks share ``cuda:0``: prints
    the refusal."""
    try:
        init_multihost(device="cuda:0", backend="nccl")
    except RuntimeError as e:
        print(f"REFUSED {e}", flush=True)
        return
    print("JOINED", flush=True)


def start_ranks(mode: str, out_dir: str) -> list[str]:
    """Start ``RANKS`` ranks of this file in ``mode``, joined through the
    ``MGS_*`` variables; wait for each within ``RANK_TIMEOUT_S`` and
    return their outputs (every rank is killed on a timeout)."""
    port = _free_port()
    procs = []
    for r in range(RANKS):
        env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1",
                   MGS_COORDINATOR=f"tcp://127.0.0.1:{port}",
                   MGS_NUM_PROCESSES=str(RANKS), MGS_PROCESS_ID=str(r))
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), mode, out_dir],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env,
            text=True))
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=RANK_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append(out)
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{out[-4000:]}"
    return outs


# -------------------------------------------------------------- the tests

@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Both ranks' results, from one start."""
    out_dir = str(tmp_path_factory.mktemp("ranks"))
    start_ranks("--rank", out_dir)
    return [torch.load(os.path.join(out_dir, f"rank{r}.pt"),
                       weights_only=False) for r in range(RANKS)]


@pytest.fixture(scope="module")
def jax_ref():
    """The JAX package's one-process setup labels and solve count."""
    import jax.numpy as jnp
    from multigridsolver_tpu.cli import generators as jgen
    from multigridsolver_tpu.setup.aggregation import build_amg_setup as jset
    from multigridsolver_tpu.solve.api import solve_hierarchy as jsolve
    from multigridsolver_tpu.solve.hierarchy import build_hierarchy as jbuild
    from multigridsolver_tpu.utils.config import (
        AggregationConfig as JAgg, HierarchyConfig as JHier)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MGS_NO_WARMSET", "1")
        a = jgen.poisson2d(GRID)
        ref = jset(a.to_ell(dtype=jnp.float64),
                   JHier(max_coarse_size=64, aggregation=JAgg(npass=2)))
        hier = jbuild(ref.matrices[0], ref.level_labels, ref.matrices[1:],
                      smoother_kind="chebyshev", cycle="vcycle")
        res = jsolve(hier, rhs(a.shape[0]), tol=TOL)
        return dict(labels=[np.asarray(l) for l in ref.level_labels],
                    sizes=[m.nrows for m in ref.matrices],
                    iterations=int(res.iterations))


@pytest.fixture(scope="module")
def port_one_process():
    """The port's one-process setup, hierarchy and solve of each grid."""
    out = {}
    for grid in (GRID, WIDE):
        ell = wide_ell(grid)
        setup = build_amg_setup(ell, config())
        hier = build_hierarchy(setup.matrices[0], setup.level_labels,
                               setup.matrices[1:], smoother_kind="chebyshev",
                               cycle="vcycle")
        res = solve_hierarchy(hier, rhs(ell.nrows), tol=TOL)
        out[grid] = dict(hier=hier, x=res.x.numpy(), setup=setup,
                         iterations=res.iterations)
    return out


def every_layout():
    return [(grid, spr, sl) for grid, spr, sls in LAYOUT_RUNS
            for sl in sls]


def test_ranks_joined_through_environment(ranks):
    assert [r["rank"] for r in ranks] == list(range(RANKS))
    assert all(r["world"] == RANKS and r["backend"] == "gloo"
               for r in ranks)


@pytest.mark.parametrize("spr", [1, 2])
def test_labels_bitwise_jax(ranks, jax_ref, spr):
    for r in ranks:
        got = r["layouts"][(GRID, spr, 1)]
        assert got["sizes"] == jax_ref["sizes"]
        assert len(got["labels"]) == len(jax_ref["labels"])
        for lvl, (mine, ref) in enumerate(zip(got["labels"],
                                              jax_ref["labels"])):
            m = min(mine.shape[0], ref.shape[0])
            np.testing.assert_array_equal(mine[:m], ref[:m],
                                          err_msg=f"level {lvl}")
            assert (mine[m:] < 0).all() and (ref[m:] < 0).all()


@pytest.mark.parametrize("spr,sl", LAYOUTS)
def test_solve_matches_jax_count(ranks, jax_ref, spr, sl):
    for r in ranks:
        got = r["layouts"][(GRID, spr, sl)]
        assert got["iterations"] == jax_ref["iterations"]


@pytest.mark.parametrize("grid,spr,sl", every_layout())
def test_labels_bitwise_one_process(ranks, port_one_process, grid, spr,
                                    sl):
    """Every layout's labels are the port's one-process setup's; on the
    wide grid the finest level's setup spans both ranks."""
    want = port_one_process[grid]["setup"].level_labels
    for r in ranks:
        got = r["layouts"][(grid, spr, sl)]
        assert len(got["labels"]) == len(want)
        for mine, ref in zip(got["labels"], want):
            m = min(mine.shape[0], ref.shape[0])
            np.testing.assert_array_equal(mine[:m], ref.numpy()[:m])
        if grid == WIDE:
            assert got["rows0"] < wide_ell(grid).nrows


@pytest.mark.parametrize("grid,spr,sl", every_layout())
def test_solve_matches_one_process(ranks, port_one_process, grid, spr, sl):
    one = port_one_process[grid]
    for r in ranks:
        got = r["layouts"][(grid, spr, sl)]
        assert got["status"] == 0 and got["relres"] < TOL
        assert got["iterations"] == one["iterations"]
        np.testing.assert_allclose(got["x"], one["x"], rtol=1e-9,
                                   atol=1e-12)
        assert got["routes"][:sl] == ["HaloOp"] * sl
    np.testing.assert_array_equal(ranks[0]["layouts"][(grid, spr, sl)]["x"],
                                  ranks[1]["layouts"][(grid, spr, sl)]["x"])


@pytest.mark.parametrize("grid,spr,sl", every_layout())
def test_restriction_bitwise(ranks, port_one_process, grid, spr, sl):
    hs = shard_hierarchy(port_one_process[grid]["hier"],
                         RowMesh(RANKS * spr, "cpu"), shard_levels=sl)
    want = [tf.restrict_fast(hs.levels[lvl].tplan, torch.from_numpy(
        np.random.RandomState(5 + lvl).rand(hs.levels[lvl].a.npad)))
        for lvl in range(sl)]
    for r in ranks:
        got = r["layouts"][(grid, spr, sl)]["restricted"]
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert torch.equal(torch.from_numpy(g), w)


@pytest.mark.parametrize("grid,spr,sl", every_layout())
def test_replicated_levels_identical(ranks, grid, spr, sl):
    digests = {r["layouts"][(grid, spr, sl)]["digest"] for r in ranks}
    assert len(digests) == 1


@pytest.mark.parametrize("spr", [1, 2])
def test_collectives_match_one_process(ranks, spr):
    ndev = RANKS * spr
    one = RowMesh(ndev, "cpu")
    x, flags, blocks, parts = collective_inputs(ndev, 4 * HALO_H)
    halo = one.boundary_halo(x, HALO_H)
    bool_halo = one.boundary_halo(flags, HALO_H)
    a2a = one.all_to_all(blocks)
    for r in ranks:
        got = r["collectives"][spr]
        mine = slice(r["rank"] * spr, (r["rank"] + 1) * spr)
        assert torch.equal(got["halo"], halo[mine])
        assert torch.equal(got["bool_halo"], bool_halo[mine])
        assert torch.equal(got["all_to_all"], a2a[mine])
        assert torch.equal(got["all_gather"], one.all_gather(parts))
        np.testing.assert_allclose(got["sum"], x.sum(), rtol=1e-14)
        assert got["max"] == x.max()
        assert bool(got["any"]) == bool(flags.view(RANKS, -1)[:, 0].any())
        np.testing.assert_allclose(got["dot"], torch.dot(x, x), rtol=1e-14)


def test_skipass_labels_bitwise(ranks):
    """skipass over ranks: the counts are all-reduced, pass 1 pairs
    nothing and the extra pass runs, as in one process."""
    ref = build_amg_setup(wide_ell(WIDE), config(**SKIPASS))
    assert len(ref.rounds[0].passes) == 3
    for r in ranks:
        assert len(r["skipass"]) == len(ref.level_labels)
        for mine, want in zip(r["skipass"], ref.level_labels):
            m = min(mine.shape[0], want.shape[0])
            np.testing.assert_array_equal(mine[:m], want.numpy()[:m])


def test_shard_functions_keep_local_rows(ranks):
    """put_global, shard_vector and shard_operator keep this rank's rows
    of what the one-process mesh holds whole."""
    ell = wide_ell(WIDE)
    one = RowMesh(2 * RANKS, "cpu")
    whole = shard_operator(ell, one)
    hyb = shard_operator(hybrid_from_ell(ell), one)
    v = torch.from_numpy(np.random.RandomState(8).rand(ell.npad))
    for r in ranks:
        got = r["shard"]
        n = got["cols"].shape[1]
        lo = r["rank"] * n
        rows = slice(lo, lo + n)
        assert torch.equal(got["put_global"], v[rows])
        assert torch.equal(got["shard_vector"], v[rows])
        assert torch.equal(got["cols"], whole.cols[:, rows])
        assert torch.equal(got["vals"], whole.vals[:, rows])
        assert torch.equal(got["rownnz"], whole.rownnz[rows])
        assert got["row0"] == lo and got["marker"][0] == n // 2
        assert torch.equal(got["dvals"], hyb.dvals[:, rows])


def test_transport_counts_bytes(ranks):
    for r in ranks:
        assert r["sent"]["exchange"] > 0 and r["sent"]["all_gather"] > 0
        assert r["sent"]["all_reduce_sum"] > 0


def test_init_multihost_refusals(monkeypatch):
    for var in ("MGS_COORDINATOR", "MGS_NUM_PROCESSES", "MGS_PROCESS_ID"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(ValueError, match="coordinator"):
        init_multihost(device="cpu")
    with pytest.raises(ValueError, match="NCCL runs on cards only"):
        init_multihost("127.0.0.1:1", 2, 0, backend="nccl", device="cpu")
    with pytest.raises(ValueError, match="backend"):
        init_multihost("127.0.0.1:1", 2, 0, backend="mpi", device="cpu")
    if not torch.cuda.is_available():
        # no card: the rank's default device is refused, not replaced
        with pytest.raises(RuntimeError, match="no card"):
            init_multihost("127.0.0.1:1", 2, 0)


def test_one_process_mesh_refuses_device_list():
    with pytest.raises(NotImplementedError, match="one rank per card"):
        RowMesh(2, ["cpu", "meta"])


@pytest.mark.cuda
def test_nccl_refuses_two_ranks_on_one_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    outs = start_ranks("--nccl-shared", str(tmp_path))
    for out in outs:
        assert "REFUSED" in out and "same card" in out, out[-2000:]


if __name__ == "__main__":
    # python tests/test_torch_multihost.py --rank|--nccl-shared OUT_DIR
    mode, out_dir = sys.argv[1:3]
    if mode == "--rank":
        rank_main(out_dir)
    elif mode == "--nccl-shared":
        nccl_shared_main()
    else:
        sys.exit(f"unknown mode {mode}")
