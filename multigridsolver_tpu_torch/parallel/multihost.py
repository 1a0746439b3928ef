"""Multi-process row mesh: one rank per card over ``torch.distributed``.

The counterpart of the JAX package's ``parallel/multihost.py``.  Each
process is one rank; the row mesh spans every rank's shards
(``shards_per_rank`` consecutive shards each), every rank holds only its
own rows of each sharded level, and the mesh's collectives
(:class:`~.sharded.RowMesh`) run on :class:`RankComm`: NCCL between
cards, gloo on the CPU.  The kernels run on the rank's local block with
the halo and exchange buffers the collectives deliver; the transport
itself runs outside them.

Wiring, per rank:

* :func:`init_multihost` (arguments, or the ``MGS_COORDINATOR`` /
  ``MGS_NUM_PROCESSES`` / ``MGS_PROCESS_ID`` environment variables) joins
  the process group at an explicit ``tcp://host:port``, with an explicit
  backend and device, before any collective;
* :func:`global_row_mesh` builds the row mesh over all ranks;
* :func:`put_global` keeps this rank's rows of a host array every rank
  holds; :func:`host_read` reads a sharded vector back whole (collective).

The backend is never chosen behind the caller's back: NCCL on CUDA
devices unless the caller names another, gloo on the CPU.  NCCL refuses
two ranks on one card, and :func:`init_multihost` says so before it
starts.  Gloo takes CUDA tensors for some collectives only; those it
refuses (``GLOO_STAGED``) are staged through host memory, explicitly,
inside :class:`RankComm`.
"""
from __future__ import annotations

import datetime
import os
import warnings
from collections import Counter

import numpy as np
import torch

from .sharded import RowMesh

BACKENDS = ("nccl", "gloo")
# the collectives gloo refuses on CUDA tensors, staged through host memory
# when the transport is gloo and the rank's device a card
GLOO_STAGED = frozenset({"exchange"})
# how long a rank waits for the others to join, in seconds
JOIN_TIMEOUT_S = 300

_comm: "RankComm | None" = None


class RankComm:
    """The transport of a row mesh over ranks: this rank's index, the
    world size, the backend and the rank's device, and the collectives
    the mesh is built from.  ``sent`` counts the bytes this rank handed
    the transport, by collective (:meth:`reset_counts` zeroes it)."""

    def __init__(self, rank: int, world: int, backend: str,
                 device: torch.device):
        self.rank, self.world = int(rank), int(world)
        self.backend = backend
        self.device = torch.device(device)
        self.staged = GLOO_STAGED if (backend == "gloo"
                                      and self.device.type == "cuda") \
            else frozenset()
        self.sent: Counter = Counter()

    def __repr__(self) -> str:
        return (f"RankComm(rank={self.rank}, world={self.world}, "
                f"backend={self.backend!r}, device={str(self.device)!r})")

    def describe(self) -> str:
        staged = f", staged through host: {sorted(self.staged)}" \
            if self.staged else ""
        return (f"{self.backend} over {self.world} ranks, this rank "
                f"{self.rank} on {self.device}{staged}")

    def reset_counts(self) -> None:
        self.sent.clear()

    def _count(self, name: str, *ts) -> None:
        self.sent[name] += sum(t.numel() * t.element_size()
                               for t in ts if t is not None)

    def _host(self, name: str, t: torch.Tensor | None):
        """``t`` where the transport takes it: on the host for a staged
        collective, else in place."""
        if t is None or name not in self.staged:
            return t
        return t.cpu()

    def _back(self, t: torch.Tensor | None):
        return None if t is None else t.to(self.device)

    def all_reduce(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """The elementwise sum or max of ``t`` over the ranks, on every
        rank (a new tensor)."""
        import torch.distributed as dist
        red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
        name = f"all_reduce_{op}"
        self._count(name, t)
        buf = self._host(name, t)
        buf = buf.clone() if buf is t else buf
        dist.all_reduce(buf, op=red)
        return buf if buf.device == self.device else self._back(buf)

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's flat ``t`` concatenated in rank order (all ranks
        pass one shape)."""
        import torch.distributed as dist
        self._count("all_gather", t)
        src = self._host("all_gather", t.contiguous().reshape(-1))
        out = src.new_empty((self.world * src.numel(),))
        with warnings.catch_warnings():
            # renamed all_gather_single in later releases; the same call
            warnings.simplefilter("ignore", FutureWarning)
            dist.all_gather_into_tensor(out, src)
        return out if out.device == self.device else self._back(out)

    def all_to_all(self, t: torch.Tensor) -> torch.Tensor:
        """``t``'s leading axis split into ``world`` equal chunks, chunk
        ``q`` sent to rank ``q``; returns the chunks received, chunk ``p``
        from rank ``p``."""
        import torch.distributed as dist
        self._count("all_to_all", t)
        src = self._host("all_to_all", t.contiguous())
        out = torch.empty_like(src)
        dist.all_to_all_single(out, src)
        return out if out.device == self.device else self._back(out)

    def exchange(self, to_left: torch.Tensor | None,
                 to_right: torch.Tensor | None):
        """The neighbour exchange: every rank sends ``to_left`` to rank
        − 1 and ``to_right`` to rank + 1 (a direction every rank passes
        as None is not exchanged) and returns ``(from_left, from_right)``,
        what rank − 1 sent right and rank + 1 sent left; None where no
        such rank exists."""
        import torch.distributed as dist
        has_left, has_right = self.rank > 0, self.rank + 1 < self.world
        self._count("exchange", to_left if has_left else None,
                    to_right if has_right else None)
        ops, from_left, from_right = [], None, None
        where = "cpu" if "exchange" in self.staged else self.device
        if to_right is not None:
            if has_right:
                ops.append(dist.P2POp(dist.isend, self._host(
                    "exchange", to_right.contiguous()), self.rank + 1))
            if has_left:
                from_left = torch.empty(to_right.shape, dtype=to_right.dtype,
                                        device=where)
                ops.append(dist.P2POp(dist.irecv, from_left, self.rank - 1))
        if to_left is not None:
            if has_left:
                ops.append(dist.P2POp(dist.isend, self._host(
                    "exchange", to_left.contiguous()), self.rank - 1))
            if has_right:
                from_right = torch.empty(to_left.shape, dtype=to_left.dtype,
                                         device=where)
                ops.append(dist.P2POp(dist.irecv, from_right,
                                      self.rank + 1))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        if "exchange" in self.staged:
            from_left, from_right = self._back(from_left), \
                self._back(from_right)
        return from_left, from_right


def _split_address(coordinator: str) -> tuple[str, int]:
    addr = coordinator[len("tcp://"):] if coordinator.startswith("tcp://") \
        else coordinator
    host, _, port = addr.rpartition(":")
    if not host or not port.isdigit():
        raise ValueError(f"the coordinator must be host:port or "
                         f"tcp://host:port, got {coordinator!r}")
    return host, int(port)


def _check_cards(store, rank: int, world: int, device: torch.device) -> None:
    """NCCL takes one rank per card: raise, on every rank, when two ranks
    of the group sit on the same card."""
    uuid = str(torch.cuda.get_device_properties(device).uuid)
    store.set(f"mgs_card_{rank}", uuid)
    cards = [store.get(f"mgs_card_{r}").decode() for r in range(world)]
    seen: dict[str, int] = {}
    for r, card in enumerate(cards):
        if card in seen:
            raise RuntimeError(
                f"ranks {seen[card]} and {r} of one NCCL group sit on the "
                f"same card ({card}): NCCL takes one rank per card; give "
                "each rank its own card, or ask for the gloo backend")
        seen[card] = r


def init_multihost(coordinator: str | None = None,
                   num_processes: int | None = None,
                   process_id: int | None = None,
                   backend: str | None = None,
                   device: torch.device | str | None = None) -> RankComm:
    """Join the process group of a row mesh over ranks.

    Arguments default to ``MGS_COORDINATOR`` (``host:port`` or
    ``tcp://host:port``, rank 0 listens there), ``MGS_NUM_PROCESSES``
    and ``MGS_PROCESS_ID``.  ``device`` defaults to ``cuda:<local
    rank>`` (``LOCAL_RANK``, else the process id); the CPU is used only
    when asked for.  ``backend`` defaults to NCCL on a card and gloo on
    the CPU; nothing falls back to another.  Returns the rank's
    :class:`RankComm`, which :func:`global_row_mesh` then uses."""
    import torch.distributed as dist
    global _comm
    coordinator = coordinator or os.environ.get("MGS_COORDINATOR")
    if num_processes is None and os.environ.get("MGS_NUM_PROCESSES"):
        num_processes = int(os.environ["MGS_NUM_PROCESSES"])
    if process_id is None and os.environ.get("MGS_PROCESS_ID"):
        process_id = int(os.environ["MGS_PROCESS_ID"])
    if coordinator is None or num_processes is None or process_id is None:
        raise ValueError("init_multihost needs the coordinator, the number "
                         "of processes and this process's id (arguments or "
                         "MGS_COORDINATOR / MGS_NUM_PROCESSES / "
                         "MGS_PROCESS_ID)")
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process id {process_id} outside "
                         f"[0, {num_processes})")
    if device is None:
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK",
                                                         process_id)))
    device = torch.device(device)
    if device.type == "cuda":
        if device.index is None:
            raise ValueError("name the rank's card: cuda:<index>")
        if not torch.cuda.is_available() \
                or device.index >= torch.cuda.device_count():
            raise RuntimeError(f"rank {process_id}: no card {device} "
                               "(the CPU is used only when asked for)")
        torch.cuda.set_device(device)
    elif device.type != "cpu":
        raise ValueError(f"unsupported device {device}")
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got "
                         f"{backend!r}")
    if backend == "nccl" and device.type != "cuda":
        raise ValueError("NCCL runs on cards only; the CPU takes gloo")
    if dist.is_initialized():
        raise RuntimeError("init_multihost: the process group is already "
                           "initialised")
    host, port = _split_address(coordinator)
    timeout = datetime.timedelta(seconds=JOIN_TIMEOUT_S)
    store = dist.TCPStore(host, port, num_processes, process_id == 0,
                          timeout=timeout)
    if backend == "nccl":
        _check_cards(store, process_id, num_processes, device)
    dist.init_process_group(backend, store=store, rank=process_id,
                            world_size=num_processes, timeout=timeout)
    _comm = RankComm(process_id, num_processes, backend, device)
    # every rank takes part in the group's first collective
    _comm.all_reduce(torch.zeros((1,), device=device))
    _comm.reset_counts()
    return _comm


def shutdown_multihost() -> None:
    """Leave the process group (every rank)."""
    import torch.distributed as dist
    global _comm
    if dist.is_initialized():
        dist.destroy_process_group()
    _comm = None


def is_multiprocess() -> bool:
    return _comm is not None and _comm.world > 1


def global_row_mesh(shards_per_rank: int = 1) -> RowMesh:
    """The row mesh over every rank: ``world · shards_per_rank`` shards,
    rank ``r`` holding shards ``[r·shards_per_rank, (r+1)·
    shards_per_rank)`` on its device."""
    if _comm is None:
        raise RuntimeError("call init_multihost first")
    return RowMesh(_comm.world * shards_per_rank, _comm.device, comm=_comm)


def put_global(x, mesh: RowMesh) -> torch.Tensor:
    """This rank's rows of the host array ``x`` (numpy or torch) that
    every rank passes whole, on the mesh's device."""
    x = torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x)
    if x.shape[0] % mesh.ndev:
        raise ValueError(f"length {x.shape[0]} does not split into "
                         f"{mesh.ndev} shards")
    lo, hi = mesh.local_rows(x.shape[0])
    return x[lo:hi].to(mesh.device)


def host_read(x: torch.Tensor, mesh: RowMesh | None = None) -> np.ndarray:
    """``x`` as a whole host array.  With ``mesh``: ``x`` holds this
    rank's rows of a vector sharded over it, and every rank must call
    (the rows are all-gathered).  Without: a replicated (or one-process)
    tensor, read directly."""
    if mesh is not None and mesh.over_ranks:
        x = mesh.all_gather(x.reshape(mesh.nlocal, -1))
    return x.cpu().numpy()
