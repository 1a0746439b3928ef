"""multigridsolver_tpu_torch — the AGMG main path in PyTorch, with
hand-written CUDA gather kernels for NVIDIA Hopper.

A port of ``multigridsolver_tpu`` (the JAX reference, which stays beside
it): pairwise-aggregation setup, DIA+ELL hierarchy with Jacobi,
Chebyshev, two-stage Gauss-Seidel or ILU(0) smoothing, V- and K-cycles
in multiplicative or additive combination, the two-level preconditioner
from an explicit P, and BiCGStab, CG, flexible CG or GMRES; the command
line (``python -m multigridsolver_tpu_torch``), Matrix Market I/O and the
greedy matching through the C++ host runtime ``native/mgio.cpp``, and
hierarchy checkpoints.  It imports torch, numpy and scipy, never jax.
"""
from .sparse.formats import COO, CSR, ELL
from .utils.config import (AggregationConfig, HierarchyConfig, SmootherConfig,
                           SolveConfig)

__version__ = "0.1.0"
