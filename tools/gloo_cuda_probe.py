"""Which collectives the gloo backend takes on CUDA tensors.

    python tools/gloo_cuda_probe.py [--out chiprun_out/gloo_cuda_probe.json]

For each collective the row mesh uses (``all_reduce`` with sum and max,
``all_gather_into_tensor``, ``all_to_all_single``, and the neighbour
exchange by ``batch_isend_irecv``) and each side (CUDA tensors on
``cuda:0``, host tensors), starts two fresh ranks joined over gloo
(``tcp://127.0.0.1``) and records whether both ranks ended cleanly (gloo
aborts a process it hands a device pointer to the network), whether the
result is right, and the median wall of 20 calls.  One card is enough:
this is the transport the row mesh takes when two ranks share a card
(NCCL refuses that).  Exits non-zero without a card.
"""
from __future__ import annotations

import argparse
import json
import os
import socket
import statistics
import subprocess
import sys
import time

COLLECTIVES = ("all_reduce_sum", "all_reduce_max", "all_gather_into_tensor",
               "all_to_all_single", "batch_isend_irecv")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run(name: str, dev, rank: int, world: int, n: int):
    import torch
    import torch.distributed as dist
    if name.startswith("all_reduce"):
        t = torch.full((n,), float(rank + 1), device=dev)
        op = dist.ReduceOp.SUM if name.endswith("sum") else dist.ReduceOp.MAX
        dist.all_reduce(t, op=op)
        want = float(sum(range(1, world + 1))) if name.endswith("sum") \
            else float(world)
        return bool((t == want).all())
    if name == "all_gather_into_tensor":
        t = torch.full((n,), float(rank), device=dev)
        out = torch.empty((world * n,), device=dev)
        dist.all_gather_into_tensor(out, t)
        want = torch.arange(world, device=dev).repeat_interleave(n).float()
        return bool(torch.equal(out, want))
    if name == "all_to_all_single":
        t = (torch.arange(world, device=dev) * 10 + rank).float() \
            .repeat_interleave(n)
        out = torch.empty_like(t)
        dist.all_to_all_single(out, t)
        want = (torch.arange(world, device=dev) + rank * 10).float() \
            .repeat_interleave(n)
        return bool(torch.equal(out, want))
    # the neighbour exchange: each rank sends to the other
    peer = (rank + 1) % world
    send = torch.full((n,), float(rank), device=dev)
    recv = torch.empty((n,), device=dev)
    reqs = dist.batch_isend_irecv([dist.P2POp(dist.isend, send, peer),
                                   dist.P2POp(dist.irecv, recv, peer)])
    for r in reqs:
        r.wait()
    return bool((recv == float(peer)).all())


def rank_main(rank: int, world: int, port: int, name: str,
              side: str) -> None:
    import torch
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    cuda = torch.device("cuda", 0)
    torch.cuda.set_device(cuda)
    dev = cuda if side == "cuda" else torch.device("cpu")
    n = 1 << 16
    ok = _run(name, dev, rank, world, n)
    walls = []
    for _ in range(20):
        dist.barrier()
        t0 = time.perf_counter()
        _run(name, dev, rank, world, n)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    if rank == 0:
        print("PROBE " + json.dumps(dict(right=ok, words=n,
                                         wall_ms=statistics.median(walls))),
              flush=True)
    dist.barrier()
    dist.destroy_process_group()


def probe(name: str, side: str) -> dict:
    """One collective on one side in two fresh ranks: gloo aborts the
    process when it is handed a device pointer, so each runs alone."""
    port = _free_port()
    procs = [subprocess.Popen([sys.executable, __file__, "--rank", str(r),
                               "--port", str(port), "--only", name,
                               "--side", side],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    outs, rcs = [], []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=120)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            out, _ = p.communicate()
        outs.append(out)
        rcs.append(p.returncode)
    row = dict(accepted=all(rc == 0 for rc in rcs), rcs=rcs)
    for line in outs[0].splitlines():
        if line.startswith("PROBE "):
            row.update(json.loads(line[len("PROBE "):]))
    if not row["accepted"]:
        err = [ln for out in outs for ln in out.splitlines()
               if "what()" in ln or "Error" in ln or "Bad address" in ln]
        row["error"] = " | ".join(err[:3])[:400]
    return row


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="chiprun_out/gloo_cuda_probe.json")
    ap.add_argument("--rank", type=int, default=None)
    ap.add_argument("--port", type=int, default=None)
    ap.add_argument("--only", default=None)
    ap.add_argument("--side", default="cuda")
    args = ap.parse_args()
    if args.rank is not None:
        rank_main(args.rank, 2, args.port, args.only, args.side)
        return 0
    import torch
    if not torch.cuda.is_available():
        print("gloo_cuda_probe: no CUDA device", file=sys.stderr)
        return 1
    res = {name: {side: probe(name, side) for side in ("cuda", "host")}
           for name in COLLECTIVES}
    doc = dict(torch=torch.__version__,
               device=torch.cuda.get_device_name(0), collectives=res)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(doc, f, indent=1)
    print(json.dumps(doc), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
