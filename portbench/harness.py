"""One run of one cell: set-up, the measured window, the traced probes,
the check against the reference, and the result line.

Everything a cell is made of is found by name from ``BENCHMARK.json`` at
the root of the checkout:

* the cell's ``config`` names a configuration whose ``file`` (under
  ``configs/``) holds the matrix's generator, dtype, setup, hierarchy and
  solve settings;
* its ``traffic`` names ``traffic/<traffic>.json``, the request kind and
  the stream's parameters (``traffic.py``);
* ``limits/<cell>.json`` holds the limit of every number the check
  compares;
* each metric that lists the cell (or lists no cells) is read by
  ``metrics/<name>.py``, else by ``metrics/<name before the first
  dot>.py``: a module with ``read(run)`` that returns a number, or None
  when it finds nothing to read (the metric is then left out of the
  line).

So a new configuration, traffic mix, limit file or metric is a new file
and an entry in ``BENCHMARK.json``; no file here changes.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import socket
import subprocess
import sys
import time
from pathlib import Path

import torch

from .trace import Record, profile_request, sync

HERE = Path(__file__).resolve().parent
# the top-level module names that may not be loaded once the window has
# closed: JAX and the JAX package (compared whole: the program's own name
# begins with the JAX package's)
FORBIDDEN = ("jax", "jaxlib", "flax", "multigridsolver_tpu")
# how long a run's rank processes may take before they are stopped
RANK_TIMEOUT_S = 340


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list


def _metrics_of(entries: list, cell: str, e2e: dict | None = None) -> list:
    out = []
    for m in entries:
        if "workloads" in m:
            if cell in m["workloads"]:
                out.append(m)
        elif e2e is None or m["moves"] in e2e:
            out.append(m)
    return out


def resolve(root: Path, workload: str) -> Cell:
    """The cell ``workload`` of ``root/BENCHMARK.json``, every part of it
    read from its file."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json "
                         f"(have {sorted(cells)})")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((root / configs[w["config"]]["file"]).read_text())
    traffic = json.loads((HERE / "traffic" / f"{w['traffic']}.json")
                         .read_text())
    limits = json.loads((HERE / "limits" / f"{workload}.json").read_text())
    e2e = _metrics_of(bench["end_to_end"], workload)
    per_layer = _metrics_of(bench["per_layer"], workload,
                            {m["name"] for m in e2e})
    return Cell(workload, int(w["chips"]), config, traffic, limits, e2e,
                per_layer)


def reader(name: str):
    """The ``read`` function of metric ``name``."""
    for stem in (name, name.split(".")[0]):
        path = HERE / "metrics" / f"{stem}.py"
        if path.exists():
            spec = importlib.util.spec_from_file_location(
                "portbench_metric_" + stem.replace(".", "_"), path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            return mod.read
    raise FileNotFoundError(f"no reader for metric {name!r} under "
                            f"{HERE / 'metrics'}")


@dataclasses.dataclass
class Run:
    """What a metric reader reads: the run's clocks and counts, its
    record of spans and counters, the profile of its traced request, and
    the live system for probes made after the window."""

    setup_s: float
    window_s: float
    completed: int
    rec: Record
    system: object
    device: torch.device
    profile: dict | None = None


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def compare(checks: dict, limits: dict) -> tuple[bool, dict]:
    """Each number compared beside its limit; correct if none exceeds
    it (a number with no limit, or a NaN, fails)."""
    out, ok = {}, True
    for name, value in checks.items():
        limit = limits.get(name)
        good = limit is not None and value == value and value <= limit
        ok = ok and good
        out[name] = dict(value=value, limit=limit)
    return ok, out


def device_info(device: torch.device, count: int, peak: int) -> dict:
    if device.type != "cuda":
        return dict(platform="cpu", kind="cpu", count=count,
                    memory_peak_bytes=peak)
    return dict(platform="gpu", kind=torch.cuda.get_device_name(device),
                count=count, memory_peak_bytes=peak)


def power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as exc:
        return f"nvidia-smi unavailable ({exc})"


class Solo:
    """The window's decisions in one process."""

    rank, world = 0, 1

    def agree(self, go: bool) -> bool:
        return go

    def gather(self, obj) -> list:
        return [obj]


class Ranks:
    """The window's decisions over ranks: rank 0's clock decides, and
    every rank learns it through ``torch.distributed`` (outside the
    program's transport, whose byte counts stay the program's)."""

    def __init__(self, comm):
        self.comm = comm
        self.rank, self.world = comm.rank, comm.world

    def agree(self, go: bool) -> bool:
        import torch.distributed as dist
        flag = torch.tensor([1 if go else 0], dtype=torch.int32,
                            device=self.comm.device)
        dist.broadcast(flag, 0)
        return bool(flag.item())

    def gather(self, obj) -> list:
        import torch.distributed as dist
        out = [None] * self.world
        dist.all_gather_object(out, obj)
        return out


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             device: torch.device, t0: float, mesh=None, team=None,
             out=None) -> int:
    """Set up, run the window, probe, check and (on the reporting rank)
    print the result line; returns the exit code."""
    from . import systems
    out = out or sys.stdout
    team = team or Solo()
    rec = Record(device, trace)
    system = systems.make(cell.config, cell.traffic, device, rec, seed,
                          mesh=mesh)
    system.setup()
    sync(device)
    setup_s = time.time() - t0
    attempted = failed = 0
    start = time.perf_counter()
    ends = []
    go = True
    while go:
        attempted += 1
        if not system.request(attempted - 1):
            failed += 1
        ends.append(time.perf_counter() - start)
        go = team.agree(ends[-1] < seconds)
    sync(device)
    window_s = time.perf_counter() - start
    walls = sorted(b - a for a, b in zip([0.0] + ends, ends))
    run = Run(setup_s, window_s, attempted, rec, system, device)
    if trace and device.type == "cuda":
        run.profile = profile_request(lambda: system.request(attempted),
                                      device, rec)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    busy = ({k: run.profile[k] for k in ("busy_s", "compute_busy_s")}
            if run.profile else None)
    shared = team.gather(dict(peak=peak, busy=busy))
    if run.profile:
        # each busy time averaged over the ranks' cards
        for k in busy:
            vals = [s["busy"][k] for s in shared if s["busy"] is not None]
            run.profile[k] = sum(vals) / len(vals)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        if not system.is_reporter:
            break
        value = reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = dict(value=value, unit=m["unit"])
    system.release()
    check_t0 = time.perf_counter()
    checks = system.check()
    check_s = time.perf_counter() - check_t0
    # every rank looks at what it holds once its check is done, and the
    # reporting rank refuses before it writes anything
    found = sorted({m for f in team.gather(forbidden_modules()) for m in f})
    if found:
        print(f"portbench: modules loaded that the port may not load: "
              f"{found}", file=sys.stderr)
        return 3
    if not system.is_reporter:
        return 0
    ok, compared = compare(checks, cell.limits)
    dev = device_info(device, team.world, max(s["peak"] for s in shared))
    result = dict(correct=ok and failed == 0, attempted=attempted,
                  failed=failed, metrics=metrics, device=dev)
    if run.profile:
        dev.update(busy_s=run.profile["busy_s"],
                   window_s=run.profile["window_s"])
        result["breakdown"] = dict(device_ops=run.profile["device_ops"],
                                   idle_gaps=run.profile["idle_gaps"])
    if trace and device.type == "cuda":
        print(f"card: {power_limit()}", file=sys.stderr)
    print(f"levels {getattr(system, 'levels', None)}; {attempted} requests "
          f"in {window_s!r} s; set-up {setup_s!r} s; request walls s: "
          f"min {walls[0]!r} median {walls[len(walls) // 2]!r} max "
          f"{walls[-1]!r}, the first {ends[0]!r}; check {check_s!r} s",
          file=sys.stderr)
    print("request ends s: " + " ".join(f"{e:.4f}" for e in ends),
          file=sys.stderr)
    for name, c in compared.items():
        print(f"{name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    result["checks"] = compared
    print(json.dumps(result), file=out, flush=True)
    return 0


def free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def launch_ranks(cell: Cell, argv: list[str], t0: float,
                 rank_device: str = "cuda",
                 command: list[str] | None = None) -> tuple[int, str | None]:
    """Start the cell's rank processes (this package with ``--rank``),
    every rank's output on this process's standard error, and wait for
    all.  Rank 0 writes its result line to a file.  Returns the exit
    code and, once every rank has exited 0, that line.  Any rank that
    fails or outlives ``RANK_TIMEOUT_S`` fails the run with no line, and
    every rank is stopped."""
    import tempfile
    ranks = int(cell.traffic["ranks"])
    coordinator = f"tcp://127.0.0.1:{free_port()}"
    command = command or [sys.executable, "-m", "portbench"]
    procs = []
    with tempfile.TemporaryDirectory(prefix="portbench_") as tmp:
        result = Path(tmp) / "result.json"
        try:
            for r in range(ranks):
                procs.append(subprocess.Popen(
                    command + argv + ["--rank", str(r), "--coordinator",
                                      coordinator, "--t0", repr(t0),
                                      "--rank-device", rank_device,
                                      "--result", str(result)],
                    stdout=sys.stderr))
            deadline = time.monotonic() + RANK_TIMEOUT_S
            codes = [p.wait(timeout=max(deadline - time.monotonic(), 1.0))
                     for p in procs]
        except subprocess.TimeoutExpired:
            print(f"portbench: a rank outlived {RANK_TIMEOUT_S} s",
                  file=sys.stderr)
            codes = [1]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        code = next((c for c in codes if c != 0), 0)
        if code or not result.exists():
            return code or 1, None
        return 0, result.read_text().strip()


def report_ranks(cell: Cell, argv: list[str], t0: float,
                 rank_device: str = "cuda",
                 command: list[str] | None = None) -> int:
    """Run the cell's ranks (:func:`launch_ranks`); then, if this process
    holds none of ``FORBIDDEN``, print the compared numbers beside their
    limits on standard error and rank 0's line on standard output."""
    code, line = launch_ranks(cell, argv, t0, rank_device, command)
    found = forbidden_modules()
    if found:
        print(f"portbench: modules loaded that the port may not load: "
              f"{found}", file=sys.stderr)
        return code or 3
    if line is None:
        return code
    for name, c in json.loads(line)["checks"].items():
        print(f"{name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(line, flush=True)
    return 0


def rank_main(cell: Cell, args, t0: float) -> int:
    """One rank of a cell over ranks: join, run, leave."""
    from multigridsolver_tpu_torch.parallel import (global_row_mesh,
                                                    init_multihost,
                                                    shutdown_multihost)
    on_card = args.rank_device == "cuda"
    device = torch.device("cuda", args.rank) if on_card \
        else torch.device("cpu")
    comm = init_multihost(args.coordinator, int(cell.traffic["ranks"]),
                          args.rank,
                          backend=cell.traffic["backend"] if on_card
                          else "gloo", device=device)
    try:
        mesh = global_row_mesh(int(cell.traffic.get("shards_per_rank", 1)))
        if args.rank != 0:
            return run_cell(cell, args.seed, args.seconds, bool(args.trace),
                            device, t0, mesh=mesh, team=Ranks(comm))
        # rank 0 alone writes the result, for the launcher to print
        with open(args.result, "w", encoding="utf-8") as out:
            return run_cell(cell, args.seed, args.seconds, bool(args.trace),
                            device, t0, mesh=mesh, team=Ranks(comm),
                            out=out)
    finally:
        shutdown_multihost()


def main(argv: list[str] | None = None, t0: float | None = None) -> int:
    import argparse
    t0 = time.time() if t0 is None else t0
    ap = argparse.ArgumentParser(
        prog="python3 -m portbench",
        description="Run one cell of BENCHMARK.json once and print its "
                    "result as the last line of standard output.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    # set by the rank launcher only
    ap.add_argument("--rank", type=int, default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--coordinator", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--t0", type=float, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--rank-device", default="cuda", choices=("cuda", "cpu"),
                    help=argparse.SUPPRESS)
    ap.add_argument("--result", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    root = Path.cwd()
    cell = resolve(root, args.workload)
    if args.rank is not None:
        return rank_main(cell, args, args.t0)
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell.chips:
        print(f"portbench: {cell.name} needs {cell.chips} CUDA device(s); "
              f"torch sees {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    if int(cell.traffic.get("ranks", 1)) > 1:
        own = ["--workload", args.workload, "--seed", str(args.seed),
               "--seconds", repr(args.seconds), "--trace", str(args.trace)]
        return report_ranks(cell, own, t0)
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    return run_cell(cell, args.seed, args.seconds, bool(args.trace), device,
                    t0)
