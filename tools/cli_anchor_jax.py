#!/usr/bin/env python3
"""The JAX package's command line, run on the CPU at full size: the
anchors of the PyTorch port's command-line session (``chip_smoke.py``'s
``cli`` phase).

    MGS_NO_WARMSET=1 JAX_PLATFORMS=cpu python tools/cli_anchor_jax.py \
        [--only generate setup greedy multilevel two_level] \
        [--grid 1000] [--small-grid 250] [--workdir DIR] \
        [--out tools/cli_anchor_results.json]

Each command is the JAX CLI's own command function, called as
``build_parser().parse_args([...])`` then ``args.fn(args)`` (not
``main()``, which would repoint the JAX compile cache; float32 commands
leave x64 off, as ``main`` does for ``--f32``).  The session, in one work
directory (``--workdir``, else a temporary one removed at the end):

* ``generate``: ``generate poisson 1000``, the SHA-256 of
  ``poisson1000000.mtx``;
* ``setup``: ``setup poisson1000000 --f32 -v``: the SHA-256 of
  ``poisson1000000promatrix_tpu.mtx`` and the command's ``[info]`` lines
  but the ``wrote`` line (per-pass nc / nnz, pairs / singletons /
  excluded, the pair-quality histogram);
* ``greedy``: ``setup poisson1000000 --f32 --matching greedy --tag
  greedy``: the promatrix's SHA-256 and its ``[info]`` lines (without
  ``native/libmgio.so`` the JAX package runs its numpy twin of the greedy
  pass, minutes at 10⁶ rows);
* ``multilevel``: ``solve poisson1000000 --multilevel --f32``: levels,
  iterations, relres, status;
* ``two_level``: ``generate poisson 250``, ``setup poisson62500 --f32``,
  ``solve poisson62500 --f32`` (two-level from the written P) and
  ``gridplot poisson62500``: the SHA-256 of the matrix, the promatrix and
  the colour ``.mtx``, and the solve's count, relres and status.

A group generates the files it needs when an earlier group has not.
Every group prints its lines as it goes; the results of the groups run
are merged into ``--out`` (written to a temporary file, then renamed).
"""
from __future__ import annotations

import argparse
import contextlib
import hashlib
import io
import json
import os
import shutil
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

GROUPS = ("generate", "setup", "greedy", "multilevel", "two_level")


def file_sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


class _Tee(io.TextIOBase):
    """Writes to the real stderr and keeps a copy."""

    def __init__(self, real):
        self.real, self.buf = real, io.StringIO()

    def write(self, s):
        self.real.write(s)
        self.buf.write(s)
        return len(s)

    def flush(self):
        self.real.flush()


def run_cli(workdir: str, argv: list[str]) -> tuple[list[str], int, float]:
    """One JAX CLI command; returns (its stderr lines, exit code, wall s)."""
    from multigridsolver_tpu.cli.main import build_parser
    args = build_parser().parse_args(["--dir", workdir] + argv)
    tee = _Tee(sys.stderr)
    print(f"$ {' '.join(argv)}", file=sys.stderr, flush=True)
    code = 0
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(tee):
        try:
            args.fn(args)
        except SystemExit as e:
            code = int(e.code or 0)
    return tee.buf.getvalue().splitlines(), code, time.perf_counter() - t0


def info_lines(lines: list[str]) -> list[str]:
    """The ``[info]`` lines but the ``wrote`` line (it names the path)."""
    return [l for l in lines if l.startswith("[info]")
            and not l.startswith("[info] wrote")]


def info_value(lines: list[str], label: str) -> str:
    for l in lines:
        if l.startswith("[info]") and l[7:].split(" : ")[0].strip() == label:
            return l.split(" : ", 1)[1]
    raise KeyError(label)


def ensure_matrix(workdir: str, grid: int) -> str:
    name = f"poisson{grid * grid}"
    if not os.path.exists(os.path.join(workdir, f"{name}.mtx")):
        run_cli(workdir, ["generate", "poisson", str(grid)])
    return name


def ensure_setup(workdir: str, name: str, extra=(), tag: str = "tpu"):
    path = os.path.join(workdir, f"{name}promatrix_{tag}.mtx")
    lines = []
    if not os.path.exists(path):
        lines, code, _ = run_cli(workdir, ["setup", name, "--f32", *extra])
        assert code == 0, f"setup {name} exited {code}"
    return path, lines


def solve_result(lines: list[str], code: int) -> dict:
    out = dict(status=code)
    if code == 0:
        out.update(iterations=int(info_value(lines, "Number of iterations "
                                                    "BICG")),
                   relres=float(info_value(lines, "Tolerance")))
    return out


def run_generate(args) -> dict:
    name = f"poisson{args.grid * args.grid}"
    _, _, wall = run_cli(args.workdir, ["generate", "poisson",
                                        str(args.grid)])
    path = os.path.join(args.workdir, f"{name}.mtx")
    return dict(file=f"{name}.mtx", sha256=file_sha256(path),
                bytes=os.path.getsize(path), wall_s=wall)


def run_setup(args) -> dict:
    name = ensure_matrix(args.workdir, args.grid)
    lines, code, wall = run_cli(args.workdir, ["setup", name, "--f32", "-v"])
    assert code == 0
    path = os.path.join(args.workdir, f"{name}promatrix_tpu.mtx")
    return dict(file=os.path.basename(path), sha256=file_sha256(path),
                info=info_lines(lines), wall_s=wall)


def run_greedy(args) -> dict:
    name = ensure_matrix(args.workdir, args.grid)
    lines, code, wall = run_cli(args.workdir, [
        "setup", name, "--f32", "--matching", "greedy", "--tag", "greedy"])
    assert code == 0
    path = os.path.join(args.workdir, f"{name}promatrix_greedy.mtx")
    return dict(file=os.path.basename(path), sha256=file_sha256(path),
                info=info_lines(lines), wall_s=wall)


def run_multilevel(args) -> dict:
    name = ensure_matrix(args.workdir, args.grid)
    lines, code, wall = run_cli(args.workdir, ["solve", name, "--multilevel",
                                               "--f32"])
    out = solve_result(lines, code)
    out.update(levels=json.loads(info_value(lines, "levels")), wall_s=wall)
    return out


def run_two_level(args) -> dict:
    g = args.small_grid
    name = ensure_matrix(args.workdir, g)
    mat = os.path.join(args.workdir, f"{name}.mtx")
    p_path, _ = ensure_setup(args.workdir, name)
    lines, code, wall = run_cli(args.workdir, ["solve", name, "--f32"])
    out = solve_result(lines, code)
    run_cli(args.workdir, ["gridplot", name])
    grid = os.path.join(args.workdir, f"{name}grid_tpu.mtx")
    out.update(matrix_sha256=file_sha256(mat),
               promatrix_sha256=file_sha256(p_path),
               grid_sha256=file_sha256(grid), n=g * g, wall_s=wall)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", nargs="+", choices=GROUPS, default=GROUPS)
    ap.add_argument("--grid", type=int, default=1000)
    ap.add_argument("--small-grid", type=int, default=250)
    ap.add_argument("--workdir", default=None)
    ap.add_argument("--out", default=os.path.join(
        os.path.dirname(os.path.abspath(__file__)),
        "cli_anchor_results.json"))
    args = ap.parse_args()
    os.environ.setdefault("MGS_NO_WARMSET", "1")
    own = args.workdir is None
    if own:
        args.workdir = tempfile.mkdtemp(prefix="cli_anchor_")
    os.makedirs(args.workdir, exist_ok=True)
    runners = dict(generate=run_generate, setup=run_setup,
                   greedy=run_greedy, multilevel=run_multilevel,
                   two_level=run_two_level)
    results = {}
    if os.path.exists(args.out):
        with open(args.out) as f:
            results = json.load(f)
    try:
        for g in args.only:
            t0 = time.perf_counter()
            results[g] = runners[g](args)
            results[g]["seconds"] = time.perf_counter() - t0
            tmp = args.out + ".tmp"
            with open(tmp, "w") as f:
                json.dump(results, f, indent=1, sort_keys=True)
                f.write("\n")
            os.replace(tmp, args.out)
            print(f"{g}: {json.dumps(results[g])}", flush=True)
    finally:
        if own:
            shutil.rmtree(args.workdir, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
