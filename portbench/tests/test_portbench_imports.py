"""Nothing the benchmark runs imports JAX or the JAX package (top-level
names compared whole: the program's name begins with the JAX
package's), and the reference imports nothing of the program."""
import ast
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "multigridsolver_tpu"}
# the plain reference and what it takes its inputs from
PLAIN = ("reference.py", "generators.py", "traffic.py")


def imported(path: Path) -> set[str]:
    """Top-level names of every module ``path`` imports (relative
    imports are the benchmark's own)."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


FILES = sorted(p for p in HERE.rglob("*.py") if "__pycache__" not in p.parts)


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax(path):
    assert not imported(path) & FORBIDDEN


@pytest.mark.parametrize("name", PLAIN)
def test_reference_imports_nothing_of_the_program(name):
    found = imported(HERE / name)
    assert "multigridsolver_tpu_torch" not in found
    assert found <= {"__future__", "math", "numpy", "scipy", "torch"}


def test_names_compared_whole():
    # the program's own name is not the JAX package's
    assert "multigridsolver_tpu_torch".split(".")[0] not in FORBIDDEN
    from portbench.harness import FORBIDDEN as HARNESS
    assert set(HARNESS) == FORBIDDEN
