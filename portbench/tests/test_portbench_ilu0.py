"""The ILU(0) cell as ``BENCHMARK.json`` has it, and the four-card cell
as entries would bring it back: a dry run of ``poisson2000ilu0.solve``
at a small grid on the CPU, the four-card cell resolved from its
entries, the new readers silent off the card, and the frozen plain ILU
reference."""
import importlib.util
import json
import time

import pytest
import torch

from portbench import harness, ilu_reference, systems
from portbench.generators import csky3d, poisson2d
from portbench.trace import Record

from .helpers import REPO, bench_copy, dry_run, small_cell
from .test_portbench_imports import imported

ILU_CELL = "poisson2000ilu0.solve"
MESH = "poisson2000.mesh4.solve"
READERS = ("ilu_roofline.ilu0", "ilu_factor_ms.ilu0")


@pytest.mark.parametrize("trace", [False, True])
def test_ilu0_cell_dry_run(trace):
    cell = small_cell(ILU_CELL, grid=24)
    assert cell.config["hierarchy"]["smoother_kind"] == "ilu0"
    rc, line, err = dry_run(cell, trace=trace)
    assert rc == 0, err
    assert line["correct"] is True and line["failed"] == 0
    assert line["checks"]["forward_error"]["value"] \
        <= line["checks"]["forward_error"]["limit"]
    if trace:
        # both new metrics read the card alone
        assert line["metrics"] == {}
        assert {m["name"] for m in cell.per_layer} == set(READERS)
    else:
        assert set(line["metrics"]) == {"solve_s", "setup_s"}


# the four-card cell as a later PR brings it back: it reports the
# benchmark's solve_s (not a mesh_solve_s of its own) and two readers
MESH_ENTRIES = dict(
    workload=dict(name=MESH, config="poisson2000",
                  traffic="mesh_solve_stream", chips=4,
                  why="solve_stream over 4 ranks x 1 shard on NCCL"),
    per_layer=[dict(name="transport_bytes.mesh", unit="bytes",
                    better="lower", source="program_counter",
                    layer="row mesh", moves="solve_s", workloads=[MESH]),
               dict(name="device_idle.mesh", unit="%", better="lower",
                    source="device_trace", layer="device", moves="solve_s",
                    workloads=[MESH])])


def test_mesh_cell_out_and_back_by_entries(tmp_path):
    """The four-card cell is out of the real ``BENCHMARK.json`` (its sets
    spread wider than half the bound), and resolves from entries alone:
    ``solve_s``, ``setup_s`` and its two readers, the solve cell's
    configuration and limits; the ILU cell shares all but the
    hierarchy with the solve cell."""
    with pytest.raises(SystemExit):
        harness.resolve(REPO, MESH)
    root = bench_copy(tmp_path)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append(MESH_ENTRIES["workload"])
    bench["end_to_end"][0]["workloads"].append(MESH)
    bench["per_layer"] += MESH_ENTRIES["per_layer"]
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = harness.resolve(root, MESH)
    solo = harness.resolve(REPO, "poisson2000.solve")
    assert cell.chips == 4
    assert cell.traffic["ranks"] == 4 and cell.traffic["backend"] == "nccl"
    assert cell.config == solo.config and cell.limits == solo.limits
    assert {m["name"] for m in cell.end_to_end} == {"solve_s", "setup_s"}
    assert {m["name"] for m in cell.per_layer} == {"transport_bytes.mesh",
                                                   "device_idle.mesh"}
    for m in cell.per_layer:
        assert harness.reader(m["name"]) is not None
    ilu = harness.resolve(REPO, ILU_CELL)
    assert ilu.chips == 1 and ilu.traffic == solo.traffic
    assert {k: v for k, v in ilu.config.items()
            if k not in ("name", "source", "hierarchy", "assumed")} \
        == {k: v for k, v in solo.config.items()
            if k not in ("name", "source", "hierarchy", "assumed")}


def test_new_readers_read_nothing_off_the_card():
    cell = small_cell(ILU_CELL, grid=24)
    device = torch.device("cpu")
    rec = Record(device, False)
    system = systems.make(cell.config, cell.traffic, device, rec, 5)
    system.setup()
    run = harness.Run(1.0, 1.0, 1, rec, system, device)
    for name in READERS:
        assert harness.reader(name)(run) is None


def test_frozen_reference_is_the_tests_copy():
    """The benchmark's copy of the plain ILU reference gives the tests'
    copy's factors bitwise, and imports nothing of the program."""
    spec = importlib.util.spec_from_file_location(
        "tests_ilu_reference", REPO / "tests" / "ilu_reference.py")
    theirs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(theirs)
    found = imported(REPO / "portbench" / "ilu_reference.py")
    assert found <= {"__future__", "torch"}
    for m in (poisson2d(12), csky3d(5)):
        ours = ilu_reference.csr_arrays(m)
        t0 = time.perf_counter()
        a = ilu_reference.chow_patel(*ours, 5, block=64)
        assert time.perf_counter() - t0 < 5.0
        b = theirs.chow_patel(*theirs.csr_arrays(m), 5)
        assert torch.equal(a, b)
