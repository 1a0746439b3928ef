"""Each cell's control comes out as not correct under the cell's own
limits: the reference put in the program's place in the nearest lower
precision (bfloat16 for the float32 cells) or, for the float64 answer of
``csky3d80.solution``, the program's own float32 path.  The program's
sound runs at the same small size pass."""
import pytest
import torch

from portbench import calibrate, harness

from .helpers import REPO, add_mesh_entries, bench_copy, small_cell

# the number each control has to fail, and a grid at which it does: a
# bfloat16 Pᵀ A P parts from float64 the more the deeper the hierarchy
# (4·10⁻⁴ at poisson2d(32), 5·10⁻³ at (128), 0.17 at (2000))
CELLS = {"poisson2000.solve": ("forward_error", 32),
         "poisson2000.build": ("galerkin_error", 128),
         "csky3d80.solution": ("true_residual", 12)}


@pytest.mark.parametrize("name", sorted(CELLS))
def test_control_fails_program_passes(name):
    number, grid = CELLS[name]
    cell = small_cell(name, grid)
    res = calibrate.calibrate(cell, torch.device("cpu"),
                              [2 ** 31 + 1, 2 ** 31 + 2], 1,
                              [2 ** 31 + 3, 2 ** 31 + 4, 2 ** 31 + 5])
    for seed, readings in res["program"].items():
        ok, compared = harness.compare(readings, cell.limits)
        assert ok, (seed, compared)
    for seed, readings in res["control"].items():
        ok, compared = harness.compare(readings, cell.limits)
        assert not ok, (seed, compared)
        assert readings[number] > cell.limits[number]


def test_mesh_cell_shares_the_solve_cells_check(tmp_path):
    # the four-rank cell, brought back by its entries alone, runs the
    # same configuration, comparison and control as poisson2000.solve
    root = bench_copy(tmp_path)
    add_mesh_entries(root, "poisson2000.mesh4.solve", "poisson2000")
    mesh = harness.resolve(root, "poisson2000.mesh4.solve")
    solo = harness.resolve(REPO, "poisson2000.solve")
    assert mesh.config == solo.config
    assert set(mesh.limits) == set(solo.limits) == {"forward_error"}
