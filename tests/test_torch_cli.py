"""The port's command line against the JAX package's, both on the CPU, in
one temporary directory: ``generate`` (every family), ``setup -v`` (the
promatrix file and the ``[info]`` lines), the greedy ``setup``, ``solve
--multilevel``, the two-level ``solve`` (also from the JAX-written P) and
``gridplot`` must write byte-identical ``.mtx`` files and print the same
levels and iteration counts.  The JAX commands are called as
``build_parser().parse_args([...])`` and ``args.fn(args)``: the JAX
``main`` would repoint the JAX compile cache for the rest of the
process."""
import io
import runpy
import sys
from contextlib import redirect_stderr

import pytest
import torch

from multigridsolver_tpu.cli import main as jcli
from multigridsolver_tpu_torch.cli import main as tcli

# poisson1024: the greedy setup of test_torch_io.py's poisson2d(32), and
# one level above the coarsest below --max-coarse 300
GRID = 32
NAME = f"poisson{GRID * GRID}"
FAMILIES = {"poisson": (GRID, NAME), "csky2d": (6, "CSky2d6"),
            "csky3d": (4, "CSky3d4")}


def run_jax(d, *argv):
    args = jcli.build_parser().parse_args(["--dir", str(d), *argv])
    buf = io.StringIO()
    with redirect_stderr(buf):
        args.fn(args)
    return buf.getvalue().splitlines()


def run_port(d, *argv):
    buf = io.StringIO()
    with redirect_stderr(buf):
        tcli.main(["--dir", str(d), "--torch-device", "cpu", *argv])
    return buf.getvalue().splitlines()


def info(lines, skip=("[info] wrote",)):
    return [l for l in lines if l.startswith("[info]")
            and not l.startswith(skip)]


def value(lines, label):
    for l in lines:
        if l.startswith("[info]") and l[7:].split(" : ")[0].strip() == label:
            return l.split(" : ", 1)[1]
    raise KeyError(label)


@pytest.fixture(scope="module")
def session(tmp_path_factory):
    """Both command lines' sessions, the JAX one first; every output kept
    for the tests to compare."""
    d = tmp_path_factory.mktemp("cli")
    out = {"dir": d}
    # one torch thread: beside the JAX package's thread pool, torch's own
    # threads slow the port's small CPU operations tenfold
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MGS_NO_WARMSET", "1")
        for fam, (n, name) in FAMILIES.items():
            run_jax(d, "generate", fam, str(n), "--out", f"jax_{name}")
            run_port(d, "generate", fam, str(n))
        out["setup"] = (run_jax(d, "setup", NAME, "--f32", "-v"),
                        run_port(d, "setup", NAME, "--f32", "-v"))
        greedy = ("setup", NAME, "--f32", "--matching", "greedy")
        out["greedy"] = (run_jax(d, *greedy, "--tag", "jax_greedy"),
                         run_port(d, *greedy, "--tag", "greedy"))
        ml = ("solve", NAME, "--multilevel", "--f32", "--max-coarse", "300")
        out["multilevel"] = (run_jax(d, *ml), run_port(d, *ml))
        out["two_level"] = (run_jax(d, "solve", NAME, "--f32"),
                            run_port(d, "solve", NAME, "--f32"),
                            run_port(d, "solve", NAME, "tpu", "--f32"))
        run_jax(d, "gridplot", NAME)
        run_port(d, "gridplot", NAME)
    torch.set_num_threads(threads)
    return out


def same_bytes(d, a, b):
    return (d / a).read_bytes() == (d / b).read_bytes()


@pytest.mark.parametrize("family", FAMILIES)
def test_generate_bytes_equal_jax(session, family):
    name = FAMILIES[family][1]
    assert same_bytes(session["dir"], f"jax_{name}.mtx", f"{name}.mtx")


def test_setup_promatrix_and_statistics_equal_jax(session):
    d = session["dir"]
    assert same_bytes(d, f"{NAME}promatrix_tpu.mtx",
                      f"{NAME}promatrix_torch.mtx")
    j, t = session["setup"]
    assert info(t) == info(j)
    assert any("pair-quality histogram" in l for l in t)
    assert [l.split(" : ")[0] for l in t if l.startswith("[time]")] == \
        [l.split(" : ")[0] for l in j if l.startswith("[time]")]


def test_greedy_setup_equals_jax(session):
    d = session["dir"]
    assert same_bytes(d, f"{NAME}promatrix_jax_greedy.mtx",
                      f"{NAME}promatrix_greedy.mtx")
    assert not same_bytes(d, f"{NAME}promatrix_tpu.mtx",
                          f"{NAME}promatrix_greedy.mtx")
    j, t = session["greedy"]
    assert info(t) == info(j)


def test_solve_multilevel_equals_jax(session):
    j, t = session["multilevel"]
    assert value(t, "levels") == value(j, "levels")
    assert len(eval(value(t, "levels"))) >= 2
    assert value(t, "Number of iterations BICG") == \
        value(j, "Number of iterations BICG")
    assert float(value(t, "Tolerance")) < 1e-6


def test_solve_two_level_equals_jax(session):
    """From the port's own P and from the JAX-written one (``tpu``)."""
    j, t, t_jax_p = session["two_level"]
    want = value(j, "Number of iterations BICG")
    assert value(t, "Number of iterations BICG") == want
    assert value(t_jax_p, "Number of iterations BICG") == want


def test_gridplot_equals_jax(session):
    d = session["dir"]
    assert same_bytes(d, f"{NAME}grid_tpu.mtx", f"{NAME}grid_torch.mtx")


def test_solver_failure_exits_2(session):
    buf = io.StringIO()
    with redirect_stderr(buf), pytest.raises(SystemExit) as e:
        tcli.main(["--dir", str(session["dir"]), "--torch-device", "cpu",
                   "solve", NAME, "--f32", "--maxiter", "1"])
    assert e.value.code == 2
    assert "solver problem, status 1" in buf.getvalue()


def test_defaults_and_no_cpu_fallback(session):
    """The card is the default device and ``torch`` the default tag; on a
    machine without CUDA a command that does not ask for the CPU fails."""
    p = tcli.build_parser()
    assert p.parse_args(["setup", "m"]).torch_device == "cuda"
    assert p.parse_args(["setup", "m"]).tag == "torch"
    assert p.parse_args(["solve", "m"]).device == "torch"
    assert p.parse_args(["gridplot", "m"]).device == "torch"
    if not torch.cuda.is_available():
        with redirect_stderr(io.StringIO()), \
                pytest.raises((RuntimeError, AssertionError)):
            tcli.main(["--dir", str(session["dir"]), "setup", NAME])


def test_python_m_entry_point(tmp_path, monkeypatch):
    """``python -m multigridsolver_tpu_torch`` runs the command line."""
    monkeypatch.setattr(sys, "argv", [
        "multigridsolver_tpu_torch", "--dir", str(tmp_path),
        "--torch-device", "cpu", "generate", "poisson", "4"])
    with redirect_stderr(io.StringIO()):
        runpy.run_module("multigridsolver_tpu_torch", run_name="__main__")
    assert (tmp_path / "poisson16.mtx").read_text().startswith(
        "%%MatrixMarket matrix coordinate real general\n16 16 64\n")
