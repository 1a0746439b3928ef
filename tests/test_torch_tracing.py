"""The port's tracer (``utils/timing``) on the CPU at poisson2d(32): the
K-cycle's ``level`` spans follow its visits, self times add up, the
Krylov loop's reads are counted, the results are bitwise those of an
untraced run, and with no tracer installed nothing is recorded."""
import io
from contextlib import redirect_stderr

import pytest
import torch

from multigridsolver_tpu_torch.cli.generators import poisson2d
from multigridsolver_tpu_torch.setup.aggregation import build_amg_setup
from multigridsolver_tpu_torch.solve.api import solve_hierarchy
from multigridsolver_tpu_torch.solve.hierarchy import build_hierarchy
from multigridsolver_tpu_torch.utils import timing
from multigridsolver_tpu_torch.utils.config import HierarchyConfig

GRID = 32
# (kcycle_depth, max_coarse_size): four levels above the coarsest
# (1024, 268, 69, 17 rows), so the visits double to the depth and then
# stay; a depth past the last level doubles all the way down
CYCLES = [(1, 8), (2, 8), (3, 8), (6, 100)]


def _build(max_coarse: int, kcycle_depth: int):
    ell = poisson2d(GRID).to_ell(dtype=torch.float64, device="cpu")
    setup = build_amg_setup(ell, HierarchyConfig(max_coarse_size=max_coarse))
    hier = build_hierarchy(setup.matrices[0], setup.level_labels,
                           setup.matrices[1:], cycle="kcycle",
                           pre_smooth=1, post_smooth=1,
                           kcycle_depth=kcycle_depth)
    return setup, hier


def _rhs():
    return torch.rand(GRID * GRID, dtype=torch.float64,
                      generator=torch.Generator().manual_seed(3))


@pytest.fixture(scope="module")
def built():
    return {c: _build(c[1], c[0]) for c in CYCLES}


@pytest.mark.parametrize("cycle", CYCLES)
def test_level_spans_follow_the_kcycle_visits(built, cycle):
    depth = cycle[0]
    _, hier = built[cycle]
    nl = len(hier.levels)
    tracer = timing.PhaseTimer()
    with timing.tracing(tracer):
        hier.precondition(_rhs())
    want = [2 ** min(l, depth) for l in range(nl)]
    got = [tracer.counts.get(("level", l), 0) for l in range(nl)]
    assert got == want
    assert ("level", nl) not in tracer.counts
    assert tracer.counts["coarse_solve"] == want[-1]
    assert tracer.counts["precondition"] == 1


@pytest.mark.parametrize("cycle", CYCLES[2:])
def test_self_times_add_up_within_the_precondition(built, cycle):
    _, hier = built[cycle]
    tracer = timing.PhaseTimer()
    with timing.tracing(tracer):
        for _ in range(2):
            hier.precondition(_rhs())
    own = tracer.self_times()
    assert set(own) == {("level", l) for l in range(len(hier.levels))} \
        | {"coarse_solve"}
    assert min(own.values()) >= 0.0
    assert sum(own.values()) <= tracer.times["precondition"]
    # level 0's span covers all the others, so the self times sum to it
    assert sum(own.values()) == pytest.approx(tracer.times[("level", 0)])


@pytest.mark.parametrize("method", ["bicgstab", "cg", "fcg", "gmres"])
def test_host_reads_of_one_solve(built, method):
    """BiCGStab, CG and FCG read the device once for the first residual
    and once an iteration; GMRES once before its first restart and once
    an Arnoldi step."""
    _, hier = built[CYCLES[2]]
    tracer = timing.PhaseTimer()
    with timing.tracing(tracer):
        res = solve_hierarchy(hier, _rhs(), method=method, tol=1e-8)
    assert res.status == 0 and res.iterations > 0
    assert tracer.counters["host_reads"] == res.iterations + 1
    assert tracer.counts["krylov.read"] == res.iterations + 1
    assert "host_read" not in tracer.counts


def test_results_bitwise_with_and_without_a_tracer(built):
    setup, hier = built[CYCLES[2]]
    b = _rhs()
    plain = solve_hierarchy(hier, b, tol=1e-8)
    tracer = timing.PhaseTimer()
    with timing.tracing(tracer):
        setup_t, hier_t = _build(8, 3)
        traced = solve_hierarchy(hier_t, b, tol=1e-8)
    assert torch.equal(traced.x, plain.x)
    assert traced.iterations == plain.iterations
    assert traced.relres == plain.relres
    assert len(setup_t.level_labels) == len(setup.level_labels)
    for lt, lp in zip(setup_t.level_labels, setup.level_labels):
        assert torch.equal(lt, lp)
    # the build's reads and passes were recorded too
    assert tracer.counters["host_reads"] > traced.iterations + 1
    assert tracer.counts["host_read"] == \
        tracer.counters["host_reads"] - (traced.iterations + 1)
    assert "aggregation.pass1" in tracer.counts


def test_nothing_recorded_without_a_tracer(built):
    _, hier = built[CYCLES[0]]
    assert timing.span("level", 0) is timing.NO_SPAN
    assert timing.span("precondition") is timing.NO_SPAN
    t = torch.tensor([1.5, 2.5])
    assert timing.read(t) == [1.5, 2.5]
    assert timing.read(t[0]) == 1.5
    timing.count("host_reads")
    idle = timing.PhaseTimer()
    hier.precondition(_rhs())
    assert idle.records == [] and idle.counters == {} and idle.times == {}
    with timing.tracing(idle):
        assert timing.span("x") is not timing.NO_SPAN
    # uninstalled at the end of the block
    assert timing.span("level", 0) is timing.NO_SPAN
    assert idle.marker is None          # no marker off the card


def test_report_lines_of_phases_unchanged():
    """Phases print as before; spans, levels' self times, reads and
    counters follow under their own tags."""
    timer = timing.PhaseTimer()
    with timer.phase("setup.total"):
        pass
    buf = io.StringIO()
    with redirect_stderr(buf):
        timer.report()
    lines = buf.getvalue().splitlines()
    assert len(lines) == 1
    assert lines[0].startswith("[time] setup.total (x1)")
    assert lines[0].endswith(" s") and " : " in lines[0]
    with timing.tracing(timer):
        with timing.span("level", 0):
            with timing.span("coarse_solve"):
                pass
        timing.read(torch.ones(()))
    buf = io.StringIO()
    with redirect_stderr(buf):
        timer.report()
    labels = [l.split(" : ")[0].rstrip() for l in buf.getvalue().splitlines()]
    assert labels == ["[time] setup.total (x1)", "[time] coarse_solve (x1)",
                      "[time] level 0 (x1)", "[time] level 0 self",
                      "[read] host_read (x1)", "[count] host_reads"]
