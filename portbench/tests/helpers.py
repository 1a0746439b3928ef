"""What the benchmark's tests share: cells at a small grid, run on the
CPU with the program's plain kernel versions, and a copy of the
benchmark to drop files into."""
from __future__ import annotations

import contextlib
import io
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

import torch

from portbench import harness

REPO = Path(__file__).resolve().parents[2]
# a grid per configuration that a CPU test holds
SMALL = {"poisson2000": 32, "csky3d80": 12}


def small_cell(name: str, grid: int | None = None) -> harness.Cell:
    cell = harness.resolve(REPO, name)
    base = cell.config["name"]
    cell.config["generator"]["grid"] = grid or SMALL[base]
    return cell


def dry_run(cell: harness.Cell, trace: bool = False, seed: int = 2 ** 31 + 7,
            seconds: float = 0.5) -> tuple[int, dict, str]:
    """One run of ``cell`` on the CPU: its exit code, its last line as a
    dict and the whole standard error."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stderr(err):
        rc = harness.run_cell(cell, seed, seconds, trace,
                              torch.device("cpu"), time.time(), out=out)
    lines = out.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else {}), err.getvalue()


def bench_copy(dst: Path) -> Path:
    """The benchmark's files (``BENCHMARK.json`` and ``portbench/``) copied
    into ``dst``, the program linked beside them."""
    shutil.copy(REPO / "BENCHMARK.json", dst / "BENCHMARK.json")
    shutil.copytree(REPO / "portbench", dst / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (dst / "multigridsolver_tpu_torch").symlink_to(
        REPO / "multigridsolver_tpu_torch")
    return dst


def add_small_config(root: Path, base: str, grid: int) -> str:
    """A configuration ``<base-stem><grid>`` at another grid, as a new
    file and a new entry of ``root/BENCHMARK.json``; returns its name."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    entry = next(c for c in bench["configs"] if c["name"] == base)
    cfg = json.loads((root / entry["file"]).read_text())
    name = f"{cfg['generator']['name']}{grid}"
    cfg["name"] = name
    cfg["generator"]["grid"] = grid
    path = f"portbench/configs/{name}.json"
    (root / path).write_text(json.dumps(cfg))
    bench["configs"].append(dict(entry, name=name, file=path))
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return name


# the four-card cell and its metrics as a later benchmark brings them back
# (its traffic, limits and readers are under portbench/ already)
MESH_CELL = dict(name="poisson2000.mesh4.solve", config="poisson2000",
                 traffic="mesh_solve_stream", chips=4,
                 why="solve_stream over 4 ranks x 1 shard on NCCL")
MESH_METRICS = dict(
    end_to_end=[dict(name="mesh_solve_s", unit="s", better="lower",
                     bound=0.25, source="host_clock")],
    per_layer=[dict(name="transport_bytes.mesh", unit="bytes",
                    better="lower", source="program_counter",
                    layer="row mesh", moves="mesh_solve_s"),
               dict(name="device_idle.mesh", unit="%", better="lower",
                    source="device_trace", layer="device",
                    moves="mesh_solve_s")])


def add_mesh_entries(root: Path, cell: str, config: str) -> None:
    """The four-card cell ``cell`` on ``config``, with its metrics, as
    new entries of ``root/BENCHMARK.json``."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append(dict(MESH_CELL, name=cell, config=config))
    for kind, entries in MESH_METRICS.items():
        names = {m["name"] for m in bench[kind]}
        for m in entries:
            if m["name"] not in names:
                bench[kind].append(dict(m, workloads=[]))
            entry = next(x for x in bench[kind] if x["name"] == m["name"])
            entry["workloads"].append(cell)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))


def add_mesh_cell(root: Path, grid: int = 64) -> str:
    """``poisson2000.mesh4.solve`` at another grid, as new files and
    entries of ``root/BENCHMARK.json``; returns the cell's name."""
    name = add_small_config(root, "poisson2000", grid)
    cell = f"{name}.mesh4.solve"
    add_mesh_entries(root, cell, name)
    (root / "portbench/limits" / f"{cell}.json").write_text(
        (REPO / "portbench/limits/poisson2000.mesh4.solve.json").read_text())
    return cell


def run_ranks(root: Path, cell: str, seed: int, seconds: float, trace: int,
              command: list[str] | None = None, preload: str | None = None):
    """The launcher of a cell over ranks, its ranks on the CPU over gloo,
    from ``root``; the finished process.  ``preload``: a module name the
    launcher holds (an empty module) while its ranks run."""
    script = ("import sys, time, types; from pathlib import Path; "
              "from portbench import harness; "
              f"cell = harness.resolve(Path('.'), {cell!r}); "
              f"name = {preload!r}; "
              "name and sys.modules.setdefault(name, types.ModuleType(name)); "
              "sys.exit(harness.report_ranks(cell, sys.argv[1:], "
              f"time.time(), rank_device='cpu', command={command!r}))")
    return subprocess.run(
        [sys.executable, "-c", script, "--workload", cell, "--seed",
         str(seed), "--seconds", str(seconds), "--trace", str(trace)],
        cwd=root, capture_output=True, text=True, timeout=300)
