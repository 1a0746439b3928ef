"""Where the port's setup, hierarchy build and solve synchronise the card.

    python tools/sync_check_torch.py [--grid 2000] [--csky 80]
                                     [--out chiprun_out/sync_check.json]

Builds poisson2d(grid) as the benchmark's ``poisson2000`` configuration
does (``portbench/configs/poisson2000.json``), runs one build
(``build_amg_setup`` + ``build_hierarchy``) and one ``solve_hierarchy``
to warm the card, then the same again under
``torch.cuda.set_sync_debug_mode("warn")``: every call that makes the
host wait on the card raises a warning, whose Python stack is kept.  A
call whose stack passes through ``utils/timing.read`` is a routed read
(inside its ``host_read`` or ``krylov.read`` span); any other is
reported by its innermost frame in the port, with the frames that led
there.  With ``--csky`` it also builds csky3d(n) from its host CSR as the
``csky3d80`` configuration does (the union pack, then one build).

Prints one JSON object (also written to ``--out``) with the counts of
routed and unrouted synchronising calls per phase, the ``host_reads``
the program's tracer counted, and the unrouted sites.  Exits non-zero
without a card.
"""
from __future__ import annotations

import argparse
import collections
import json
import sys
import traceback
import warnings
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

PORT = "multigridsolver_tpu_torch"


def _config(name: str) -> dict:
    return json.loads((ROOT / "portbench" / "configs" / f"{name}.json")
                      .read_text())


class SyncLog:
    """The stacks of the synchronising calls made while it listens."""

    def __init__(self):
        self.calls: list[list[traceback.FrameSummary]] = []

    def show(self, message, category, filename, lineno, file=None,
             line=None):
        if "synchronizing CUDA operation" in str(message):
            self.calls.append(traceback.extract_stack()[:-1])

    def listen(self, phase: str, fn):
        """``fn()`` with the card warning of every synchronising call and
        the program's tracer installed; (phase, stacks, host_reads the
        tracer counted, fn's result)."""
        from multigridsolver_tpu_torch.utils import timing
        self.calls = []
        tracer = timing.PhaseTimer(device=torch.device("cuda", 0))
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings(), timing.tracing(tracer):
                warnings.showwarning = self.show
                warnings.simplefilter("always")
                out = fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        return phase, self.calls, tracer.counters.get("host_reads", 0), out


def _routed(stack) -> bool:
    return any(f.filename.endswith("utils/timing.py") and f.name == "read"
               for f in stack)


def _site(stack) -> str:
    port = [f for f in stack if PORT in f.filename]
    chain = port[-3:] if port else stack[-3:]
    return " <- ".join(f"{Path(f.filename).name}:{f.lineno} {f.name}"
                       for f in reversed(chain))


def summarise(phase: str, calls, host_reads: int) -> dict:
    routed = sum(_routed(s) for s in calls)
    sites = collections.Counter(_site(s) for s in calls if not _routed(s))
    return dict(phase=phase, calls=len(calls), routed=routed,
                unrouted=len(calls) - routed, host_reads=host_reads,
                unrouted_sites=[[k, v] for k, v in sites.most_common()])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--grid", type=int, default=2000)
    ap.add_argument("--csky", type=int, default=0)
    ap.add_argument("--out", default="chiprun_out/sync_check.json")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("sync_check_torch: no CUDA device", file=sys.stderr)
        return 2
    from portbench.generators import csky3d, poisson2d
    from portbench.systems import hierarchy_config
    from multigridsolver_tpu_torch.setup.aggregation import build_amg_setup
    from multigridsolver_tpu_torch.solve.api import solve_hierarchy
    from multigridsolver_tpu_torch.solve.hierarchy import build_hierarchy
    from multigridsolver_tpu_torch.sparse.formats import CSR

    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    log = SyncLog()
    report = dict(card=torch.cuda.get_device_name(device),
                  torch=torch.__version__, phases=[])

    def build(cfg, ell):
        setup = build_amg_setup(ell, hierarchy_config(cfg))
        hier = build_hierarchy(setup.matrices[0], setup.level_labels,
                               setup.matrices[1:], **cfg["hierarchy"])
        torch.cuda.synchronize(device)
        return hier

    cfg = _config("poisson2000")
    ell = CSR.from_scipy(poisson2d(args.grid)).to_ell(
        dtype=torch.float32, device=device, **cfg["pack"])
    b = torch.rand(ell.nrows, device=device, generator=torch.Generator(
        device=device).manual_seed(7))
    sv = cfg["solve"]

    def solve(hier):
        res = solve_hierarchy(hier, b, method=sv["method"],
                              tol=float(sv["tol"]),
                              maxiter=int(sv["maxiter"]))
        torch.cuda.synchronize(device)
        return res

    solve(build(cfg, ell))
    phase, calls, reads, hier = log.listen("poisson.build",
                                           lambda: build(cfg, ell))
    report["phases"].append(summarise(phase, calls, reads))
    phase, calls, reads, res = log.listen("poisson.solve",
                                          lambda: solve(hier))
    report["phases"].append(dict(summarise(phase, calls, reads),
                                 iterations=res.iterations))
    if args.csky:
        ccfg = _config("csky3d80")
        csr = CSR.from_scipy(csky3d(args.csky))
        cell = csr.to_ell(dtype=torch.float32, device=device,
                          **ccfg["pack"])
        build(ccfg, cell)
        phase, calls, reads, _ = log.listen("csky.build",
                                            lambda: build(ccfg, cell))
        report["phases"].append(summarise(phase, calls, reads))
    text = json.dumps(report, indent=1)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(text)
    print(text)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
