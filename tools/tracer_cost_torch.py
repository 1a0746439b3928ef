"""What the port's tracer (``utils/timing``) costs, off and on.

    python tools/tracer_cost_torch.py --workload poisson2000.solve \\
        --seeds 1 2 3 4 5 6 --seconds 20 [--out chiprun_out/cost.json]
    python tools/tracer_cost_torch.py --spans-only

For one cell of ``BENCHMARK.json`` (``solve`` or ``solution`` kind) sets
the system up once as the benchmark does, then for each seed draws that
seed's requests and runs two windows of ``--seconds`` each, one with a
tracer installed around the window and one without, in turns (the
order flips with every seed).  A window's number is the benchmark's:
its wall time over the requests completed in it, each request ending in
a synchronise.  Also times the sites themselves: ``timing.span`` and
``timing.read`` (a 0-d tensor already computed) with no tracer and with
one, per call.  Prints one JSON object (also written to ``--out``).
Times are the card's only where the card ran them (``device`` says
which).
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from multigridsolver_tpu_torch.utils import timing  # noqa: E402


def per_call(fn, n: int) -> float:
    """Mean seconds a call of ``fn`` over ``n`` calls (best of 5)."""
    best = float("inf")
    for _ in range(5):
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        best = min(best, (time.perf_counter() - t0) / n)
    return best


def site_costs(device: torch.device, n: int = 100_000) -> dict:
    def one_span():
        with timing.span("level", 3):
            pass

    t = torch.ones((), device=device) * 2.0
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    out = dict(span_off_s=per_call(one_span, n),
               read_off_s=per_call(lambda: timing.read(t), n // 10))
    tracer = timing.PhaseTimer(device=device)
    with timing.tracing(tracer):
        out["span_on_s"] = per_call(one_span, n)
        out["read_on_s"] = per_call(lambda: timing.read(t), n // 10)
    return out


def window(system, seconds: float) -> tuple[float, int]:
    """The benchmark's window: requests back to back for ``seconds``
    (nothing kept); returns (window wall / requests, requests)."""
    from portbench.trace import sync
    one = getattr(system, "solve_one", None) or system.solution_one
    done = 0
    sync(system.device)
    start = time.perf_counter()
    while True:
        one(done, keep=False)
        done += 1
        if time.perf_counter() - start >= seconds:
            break
    sync(system.device)
    return (time.perf_counter() - start) / done, done


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", default="poisson2000.solve")
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--spans-only", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    on_card = torch.cuda.is_available()
    device = torch.device("cuda", 0) if on_card else torch.device("cpu")
    report = dict(device=torch.cuda.get_device_name(device) if on_card
                  else "cpu", sites=site_costs(device))
    if not args.spans_only:
        if not on_card:
            print("tracer_cost_torch: the windows need a CUDA device",
                  file=sys.stderr)
            return 2
        from portbench import harness, systems
        from portbench.trace import Record
        cell = harness.resolve(ROOT, args.workload)
        system = systems.make(cell.config, cell.traffic, device,
                              Record(device, False), args.seeds[0])
        system.setup()
        runs = []
        for k, seed in enumerate(args.seeds):
            got = {}
            for on in ((False, True) if k % 2 == 0 else (True, False)):
                system.reseed(seed)
                if on:
                    tracer = timing.PhaseTimer(device=device)
                    with timing.tracing(tracer):
                        got["on"] = window(system, args.seconds)
                    got["spans_per_request"] = \
                        len(tracer.records) / got["on"][1]
                else:
                    got["off"] = window(system, args.seconds)
            runs.append(dict(seed=seed, off_s=got["off"][0],
                             on_s=got["on"][0], requests=[got["off"][1],
                                                          got["on"][1]],
                             spans_per_request=got["spans_per_request"]))
            print(json.dumps(runs[-1]), file=sys.stderr, flush=True)
        off = [r["off_s"] for r in runs]
        on = [r["on_s"] for r in runs]
        report.update(workload=args.workload, seconds=args.seconds,
                      runs=runs, off_median_s=statistics.median(off),
                      on_median_s=statistics.median(on),
                      on_over_off_median=statistics.median(
                          [b / a for a, b in zip(off, on)]))
    text = json.dumps(report, indent=1)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text)
    print(text)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
