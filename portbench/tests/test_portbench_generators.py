"""The benchmark's frozen generators against the program's: the same
pattern and values, bitwise, at small grids."""
import numpy as np
import pytest

from multigridsolver_tpu_torch.cli import generators as program
from portbench import generators as frozen


def same(a, b) -> bool:
    return (np.array_equal(a.indptr, b.indptr)
            and np.array_equal(a.indices, b.indices)
            and a.data.dtype == b.data.dtype
            and a.data.tobytes() == b.data.tobytes()
            and tuple(a.shape) == tuple(b.shape))


@pytest.mark.parametrize("n", [1, 2, 5, 33])
def test_poisson2d_bitwise(n):
    assert same(program.poisson2d(n), frozen.poisson2d(n))


@pytest.mark.parametrize("n", [2, 4, 7, 12, 16, 20])
def test_csky3d_bitwise(n):
    assert same(program.csky3d(n), frozen.csky3d(n))


def test_generate_by_name():
    assert same(frozen.generate({"name": "csky3d", "grid": 6}),
                program.csky3d(6))
    assert frozen.generate({"name": "poisson2d", "grid": 9}).shape \
        == (81, 81)
