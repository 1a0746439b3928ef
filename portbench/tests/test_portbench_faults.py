"""With the timed path broken underneath, the rest of a run (the window,
the check, the line) reports ``correct`` false: once for each fault a
cell can have.  A solve or a build that returns its state unchanged; an
answer altered where it is produced; a hierarchy built with smoothers
that do nothing; over ranks, the exchange between ranks left out.  (No
cell takes a mean over a batch.)"""
import json
import sys

import pytest
import torch

from multigridsolver_tpu_torch.setup import aggregation
from multigridsolver_tpu_torch.solve import api, hierarchy

from .helpers import add_mesh_cell, bench_copy, dry_run, run_ranks, small_cell


def unchanged_solve(real):
    """The solve hands back its starting state: x = 0."""
    def solve(hier, b, **kw):
        res = real(hier, b, **kw)
        return res._replace(x=torch.zeros_like(res.x))
    return solve


def altered_solve(real):
    """One entry of x altered by a hundredth where it is produced."""
    def solve(hier, b, **kw):
        res = real(hier, b, **kw)
        x = res.x.clone()
        x[x.shape[0] // 3] *= 1.01
        return res._replace(x=x)
    return solve


def unchanged_refined(real):
    def solve(hier, a, b, **kw):
        x, *rest = real(hier, a, b, **kw)
        return (0.0 * x, *rest)
    return solve


def altered_refined(real):
    def solve(hier, a, b, **kw):
        x, *rest = real(hier, a, b, **kw)
        x = x.copy()
        x[len(x) // 3] *= 1.01
        return (x, *rest)
    return solve


def stale_setup(real):
    """Every build after the first hands back the first one's setup."""
    first = []

    def build(a, cfg):
        if not first:
            first.append(real(a, cfg))
        return first[0]
    return build


def altered_setup(real):
    """One stored value of the first coarse operator altered by a
    thousandth of its largest."""
    def build(a, cfg):
        setup = real(a, cfg)
        vals = setup.matrices[1].vals
        vals[0, 0] += 1e-2 * vals.abs().max()
        return setup
    return build


def idle_smoothers(real):
    """Every level's smoother does nothing (its scale zeroed: an infinite
    smoothing diagonal), so the hierarchy is the coarse correction
    alone."""
    def build(*args, **kw):
        hier = real(*args, **kw)
        for level in hier.levels:
            level.smoother.d = torch.full_like(level.smoother.d,
                                               float("inf"))
        return hier
    return build


FAULTS = [
    ("poisson2000.solve", api, "solve_hierarchy", unchanged_solve),
    ("poisson2000.solve", api, "solve_hierarchy", altered_solve),
    ("poisson2000.build", aggregation, "build_amg_setup", stale_setup),
    ("poisson2000.build", aggregation, "build_amg_setup", altered_setup),
    ("poisson2000.build", hierarchy, "build_hierarchy", idle_smoothers),
    ("csky3d80.solution", api, "solve_refined", unchanged_refined),
    ("csky3d80.solution", api, "solve_refined", altered_refined),
]


@pytest.mark.parametrize("name,module,attr,fault", FAULTS,
                         ids=[f"{f[0]}-{f[3].__name__}" for f in FAULTS])
def test_fault_reads_not_correct(name, module, attr, fault, monkeypatch):
    monkeypatch.setattr(module, attr, fault(getattr(module, attr)))
    rc, line, err = dry_run(small_cell(name))
    assert rc == 0, err
    assert line["correct"] is False, line["checks"]


def test_sound_run_reads_correct():
    rc, line, err = dry_run(small_cell("poisson2000.solve"))
    assert rc == 0 and line["correct"] is True, err


def test_mesh_exchange_left_out(tmp_path):
    root = bench_copy(tmp_path)
    cell = add_mesh_cell(root)
    proc = run_ranks(root, cell, 2 ** 31 + 6, 0.5, 0,
                     command=[sys.executable, "-m",
                              "portbench.tests.fault_rank"])
    assert proc.returncode == 0, proc.stderr[-4000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["correct"] is False, line["checks"]
