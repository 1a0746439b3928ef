"""The readings the limits under ``limits/`` are set from.

    python3 -m portbench.calibrate --workload <cell> [--seeds 12]
        [--requests 2] [--control-seeds 3] [--first-seed N] [--out FILE]

In one process on the card: the cell's set-up once, then for each of
``--seeds`` seeds the cell's own requests (``--requests`` of them, at the
cell's own size, through the timed path) and the check's numbers, the
program's readings; then for each of ``--control-seeds`` seeds the
control, the reference in the program's place in the nearest lower
precision (``systems.*.control``), and its numbers.  The benchmark's
runs never run this.  Prints one JSON object: every reading by seed, and
per number the largest the program gave and the smallest the control
gave.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch

from .harness import resolve
from .trace import Record


def calibrate(cell, device, seeds: list[int], requests: int,
              control_seeds: list[int]) -> dict:
    from . import systems
    system = systems.make(cell.config, cell.traffic, device,
                          Record(device, False), seeds[0])
    system.setup()
    program, control = {}, {}
    for seed in seeds:
        system.reseed(seed)
        for i in range(requests):
            system.request(i)
        program[str(seed)] = system.check()
    for seed in control_seeds:
        system.reseed(seed)
        system.request(0)
        control[str(seed)] = system.control(0)
    names = sorted({k for r in program.values() for k in r})
    lower = {k: max(r[k] for r in program.values()) for k in names}
    upper = {k: min(r[k] for r in control.values() if k in r)
             for k in names if any(k in r for r in control.values())}
    return dict(cell=cell.name, program=program, control=control,
                lower=lower, upper=upper,
                device=(torch.cuda.get_device_name(device)
                        if device.type == "cuda" else "cpu"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--requests", type=int, default=2)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--first-seed", type=int, default=3_000_000_001)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    cell = resolve(Path.cwd(), args.workload)
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    first = args.first_seed
    seeds = [first + 7919 * k for k in range(args.seeds)]
    control = [first + 104729 * (k + 1) for k in range(args.control_seeds)]
    t = time.perf_counter()
    res = calibrate(cell, device, seeds, args.requests, control)
    res["seconds"] = time.perf_counter() - t
    line = json.dumps(res)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
