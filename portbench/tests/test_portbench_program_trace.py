"""The readers of the program's own spans and counters
(``program_trace.py``): one request of each kind traced on the CPU at a
small grid, in this process and in a fresh one, their arithmetic against
counts by hand, and None where the program has no tracer (the parent of
the change that brought it)."""
import time

import pytest
import torch

from portbench import program_trace as pt
from portbench.harness import Run, reader
from portbench.systems import make
from portbench.trace import Record

from .helpers import small_cell

CPU = torch.device("cpu")
READERS = ["issue_ms.solve", "read_wait_ms.solve", "tail_share.solve",
           "host_reads.build", "refine_host_ms.solution",
           "host_compute_idle.solution"]


def set_up(name: str) -> Run:
    cell = small_cell(name)
    rec = Record(CPU, True)
    system = make(cell.config, cell.traffic, CPU, rec, 2 ** 31 + 11)
    system.setup()
    return Run(1.0, 1.0, 1, rec, system, CPU)


class Tracer:
    """A tracer's records as the readers see them."""

    def __init__(self, records):
        from multigridsolver_tpu_torch.utils import timing
        self.t = timing.PhaseTimer()
        for r in records:
            self.t._record(*r)


def test_solve_request_traced():
    run = set_up("poisson2000.solve")
    synced = len(run.rec.spans["solve_hierarchy"])
    got = pt.trace_request(run.system, CPU, 1)
    tracer = got["tracer"]
    pre = tracer.spans("precondition")
    reads = tracer.counters["host_reads"]
    # BiCGStab: two preconditions an iteration, a read an iteration and
    # one for the first residual
    assert len(pre) == 2 * (reads - 1) > 0
    assert tracer.counts["krylov.read"] == reads
    assert {lv for lv, _, _ in tracer.spans("level")} \
        == set(range(len(run.system.hier.levels)))
    # the harness's span only stamped the host's clock while it ran
    assert len(run.rec.spans["solve_hierarchy"]) == synced
    assert len(run.rec.stamps["solve_hierarchy"]) == 1
    share = pt.tail_share(tracer, set(range(len(run.system.hier.levels))))
    assert 0.0 < share <= 100.0
    # the readers read nothing off the card
    for name in READERS:
        assert reader(name)(run) is None


def test_build_request_counts_its_reads():
    run = set_up("poisson2000.build")
    tracer = pt.trace_request(run.system, CPU, 1)["tracer"]
    assert tracer.counters["host_reads"] == tracer.counts["host_read"] > 0
    assert "aggregation.pass1" in tracer.counts
    assert "precondition" not in tracer.counts


def test_solution_request_traced_but_not_profiled_off_the_card():
    run = set_up("csky3d80.solution")
    tracer = pt.trace_request(run.system, CPU, 1)["tracer"]
    assert len(tracer.spans("refine.residual")) >= 2
    assert {"pack.union", "pack.scatter", "pack.copy"} <= set(tracer.counts)
    # the profiled request needs the card (its marker and device trace)
    assert pt.trace_request(run.system, CPU, 2, profiled=True) is None
    got = pt.measure(run.system, CPU, 1)
    assert got["refine_host_ms"] > 0 and "host_compute_idle" not in got


def test_no_tracer_in_the_program(monkeypatch):
    from multigridsolver_tpu_torch.utils import timing
    monkeypatch.delattr(timing, "tracing")
    assert not pt.has_tracer()
    assert pt.trace_request(set_up("poisson2000.build").system, CPU,
                            1) is None


def test_tail_share_by_hand():
    # precondition [0, 10]; level 0 [0, 10] holds level 1 [1, 9], which
    # holds level 2 [2, 4] and [5, 8] and the coarse solve [6, 7]
    t = Tracer([("coarse_solve", None, 6.0, 7.0), ("level", 2, 5.0, 8.0),
                ("level", 2, 2.0, 4.0), ("level", 1, 1.0, 9.0),
                ("level", 0, 0.0, 10.0),
                ("precondition", None, 0.0, 10.0)]).t
    own = t.self_times()
    assert own == {("level", 0): 2.0, ("level", 1): 3.0, ("level", 2): 4.0,
                   "coarse_solve": 1.0}
    assert pt.tail_share(t, {2}) == pytest.approx(50.0)
    assert pt.tail_share(t, {1, 2}) == pytest.approx(80.0)
    assert pt.tail_share(t, set()) == pytest.approx(10.0)
    assert pt.tail_share(Tracer([]).t, {0}) is None


def test_host_idle_share_by_hand():
    # the device busy on [1, 2] and [4, 5] of the request [0, 10]: idle
    # [0, 1], [2, 4], [5, 10] (8); the spans cover [0.5, 3] and [9, 12]:
    # 0.5 + 1 + 1 of it
    share = pt.host_idle_share([(1.0, 2.0), (4.0, 5.0)],
                               [(9.0, 12.0), (0.5, 3.0)], 0.0, 10.0)
    assert share == pytest.approx(100.0 * 2.5 / 8.0)
    assert pt.host_idle_share([(0.0, 10.0)], [(1.0, 2.0)], 0.0, 10.0) \
        is None
    assert pt.union([(3.0, 4.0), (0.0, 1.0), (0.5, 2.0)]) == \
        [(0.0, 2.0), (3.0, 4.0)]
    assert pt.overlap([(0.0, 2.0), (3.0, 4.0)], [(1.0, 3.5)]) == \
        pytest.approx(1.5)


def test_launch_bound_levels_by_the_floor():
    run = set_up("poisson2000.solve")
    hier = run.system.hier
    # at poisson2d(32) every level's SpMV is far under 5 us at 3.35 TB/s
    assert pt.launch_bound_levels(hier) == set(range(len(hier.levels)))
    # at a peak of 1 byte/s none is
    assert pt.launch_bound_levels(hier, peak_bytes_s=1.0) == set()
    # level 0's floor: its 4,992 values of poisson2d(32) and 1,024 rows
    lvl0 = 5 * 32 ** 2 - 4 * 32
    floor = pt.spmv_floor_bytes(lvl0, 32 ** 2, 4)
    at = floor / pt.LAUNCH_FLOOR_S
    assert 0 in pt.launch_bound_levels(hier, peak_bytes_s=at * 1.001)
    assert 0 not in pt.launch_bound_levels(hier, peak_bytes_s=at * 0.999)


def test_probe_cached_on_the_run():
    run = set_up("poisson2000.build")
    t0 = time.perf_counter()
    assert pt.probe(run) is None        # the CPU: nothing probed
    assert run.program_trace is None
    assert pt.probe(run) is None
    assert time.perf_counter() - t0 < 1.0


@pytest.mark.parametrize("name", ["poisson2000.solve", "poisson2000.build"])
def test_measured_in_a_fresh_process(name):
    """The values of one request, measured here and in a new process on
    the same configuration, traffic and seed: the same keys, the same
    counts."""
    run = set_up(name)
    here = pt.measure(run.system, CPU, 1)
    there = pt.in_fresh_process(run.system, CPU)
    assert set(there) == set(here)
    assert there["host_reads"] == here["host_reads"] > 0
    if name.endswith("solve"):
        assert {"issue_ms", "read_wait_ms", "tail_share"} <= set(here)
        assert 0.0 < there["tail_share"] <= 100.0
