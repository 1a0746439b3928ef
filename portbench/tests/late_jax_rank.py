"""A rank of a cell over ranks that loads a module named ``jax`` (an
empty one) during its check, once the window has closed, if it is not
the reporting rank; for the test that no result comes out:

    python -m portbench.tests.late_jax_rank <harness arguments>
"""
import sys
import types

from portbench import systems
from portbench.harness import main


def late_jax(real):
    def check(self):
        out = real(self)
        if not self.is_reporter:
            sys.modules.setdefault("jax", types.ModuleType("jax"))
        return out
    return check


if __name__ == "__main__":
    systems.SolveSystem.check = late_jax(systems.SolveSystem.check)
    raise SystemExit(main(sys.argv[1:]))
