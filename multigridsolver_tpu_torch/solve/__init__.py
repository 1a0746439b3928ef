from .smoothers import Smoother, make_smoother
from .hierarchy import Hierarchy, Level, CoarseSolve, build_hierarchy
from .krylov import bicgstab, cg, fcg, gmres, SolveResult
from .api import (solve, solve_hierarchy, solve_refined, two_level_from_p,
                  pad_vector)
