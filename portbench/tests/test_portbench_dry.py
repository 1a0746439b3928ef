"""A dry run of each cell at a small grid on the CPU, with the program's
plain kernel versions, prints a well-formed last line."""
import json
import os
import subprocess
import sys

import pytest

from portbench import harness

from .helpers import (REPO, add_mesh_cell, bench_copy, dry_run, run_ranks,
                      small_cell)

ONE_PROCESS = ["poisson2000.solve", "poisson2000.build", "csky3d80.solution"]
KEYS = {"correct", "attempted", "failed", "metrics", "device", "checks"}


def well_formed(line: dict, cell: harness.Cell, trace: bool) -> None:
    assert KEYS <= set(line)
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] >= 1
    assert line["device"]["platform"] == "cpu"
    want = {m["name"] for m in (cell.per_layer if trace else cell.end_to_end)}
    assert set(line["metrics"]) <= want
    for name, m in line["metrics"].items():
        assert isinstance(m["value"], float) and m["value"] > 0
        assert m["unit"] == next(x["unit"] for x in cell.per_layer
                                 + cell.end_to_end if x["name"] == name)
    for c in line["checks"].values():
        assert c["value"] <= c["limit"]


@pytest.mark.parametrize("name", ONE_PROCESS)
def test_dry_run(name):
    cell = small_cell(name)
    rc, line, err = dry_run(cell)
    assert rc == 0, err
    well_formed(line, cell, False)
    # every end-to-end metric of the cell is read off the host's clock
    assert set(line["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert "setup_s" in line["metrics"]
    # each number compared is printed beside its limit, last on stderr
    tail = err.strip().splitlines()[-len(line["checks"]):]
    assert [t.split()[0] for t in tail] == list(line["checks"])


@pytest.mark.parametrize("name", ONE_PROCESS)
def test_dry_run_traced(name):
    cell = small_cell(name)
    rc, line, err = dry_run(cell, trace=True)
    assert rc == 0, err
    well_formed(line, cell, True)
    # no device number from a CPU run
    assert not any(m.startswith(("device_idle", "spmv_roofline",
                                 "kernels_per_cycle"))
                   for m in line["metrics"])
    assert "busy_s" not in line["device"]


def test_same_seed_same_inputs():
    from portbench.traffic import Stream
    import torch
    cell = small_cell("poisson2000.solve")
    a = Stream(cell.traffic, 2 ** 31 + 3, 64, torch.device("cpu"))
    b = Stream(cell.traffic, 2 ** 31 + 3, 64, torch.device("cpu"))
    c = Stream(cell.traffic, 2 ** 31 + 4, 64, torch.device("cpu"))
    assert torch.equal(a.rhs(5), b.rhs(5))
    assert not torch.equal(a.rhs(5), a.rhs(6))
    assert not torch.equal(a.rhs(5), c.rhs(5))
    build = small_cell("poisson2000.build")
    s = Stream(build.traffic, 2 ** 33, 64, torch.device("cpu")).scales()
    assert len(set(s)) == len(s) == build.traffic["copies"]
    assert all(0.5 <= v < 2.0 for v in s)


def test_no_card_no_result(tmp_path):
    """Without a card the command exits non-zero and prints nothing."""
    proc = subprocess.run(
        [sys.executable, "-m", "portbench", "--workload",
         "poisson2000.solve", "--seed", str(2 ** 31 + 11), "--seconds", "1",
         "--trace", "0"], cwd=REPO, capture_output=True, text=True,
        timeout=120)
    assert proc.returncode != 0
    assert proc.stdout == ""


def test_one_host_thread():
    """The command holds the host's thread pools to one thread, whatever
    the environment it is started in asks for."""
    proc = subprocess.run(
        [sys.executable, "-c", "import portbench.__main__, torch; "
         "print(torch.get_num_threads())"], cwd=REPO, capture_output=True,
        text=True, timeout=120, env=dict(os.environ, OMP_NUM_THREADS="4"))
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "1"


def test_mesh_cell_over_gloo_ranks(tmp_path):
    """The four-rank cell at poisson2d(64), its ranks on the CPU over
    gloo: rank 0's line printed last by the launcher, which stops every
    rank."""
    root = bench_copy(tmp_path)
    cell = add_mesh_cell(root)
    proc = run_ranks(root, cell, 2 ** 31 + 5, 1, 1)
    assert proc.returncode == 0, proc.stderr[-4000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["correct"] is True
    assert line["device"]["count"] == 4
    assert line["metrics"]["transport_bytes.mesh"]["value"] > 0
    tail = proc.stderr.strip().splitlines()[-len(line["checks"]):]
    assert [t.split()[0] for t in tail] == list(line["checks"])


@pytest.mark.parametrize("name", ["jax", "jaxlib.xla", "flax",
                                  "multigridsolver_tpu.solve"])
def test_forbidden_module_no_result(name, monkeypatch):
    """A run in whose process JAX or the JAX package is loaded once the
    window has closed exits non-zero, names it, and prints no result."""
    import types
    monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    rc, line, err = dry_run(small_cell("poisson2000.solve"))
    assert rc != 0 and line == {}
    assert name.split(".")[0] in err


def test_rank_loading_jax_in_its_check_no_result(tmp_path):
    """A rank other than the reporting one that loads ``jax`` during its
    check, after the window: the run exits non-zero, names it, and no
    result line comes out."""
    root = bench_copy(tmp_path)
    cell = add_mesh_cell(root)
    proc = run_ranks(root, cell, 2 ** 31 + 9, 0.5, 0,
                     command=[sys.executable, "-m",
                              "portbench.tests.late_jax_rank"])
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "['jax']" in proc.stderr


def test_launcher_holding_jax_no_result(tmp_path):
    """The launcher of a cell over ranks that holds ``jax`` once its
    ranks are done prints no result, though every rank was sound."""
    root = bench_copy(tmp_path)
    cell = add_mesh_cell(root)
    proc = run_ranks(root, cell, 2 ** 31 + 10, 0.5, 0, preload="jax")
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "['jax']" in proc.stderr


def test_program_name_is_not_forbidden():
    # the program's own top-level name begins with the JAX package's
    assert "multigridsolver_tpu_torch" in sys.modules \
        or __import__("multigridsolver_tpu_torch")
    assert harness.forbidden_modules() == []
