"""Phase timers and structured logging.

The reference's wall-clock ``TicToc`` timers and coloured ``printInfo``
lines.  CUDA launches return before the card has finished, so a
:class:`PhaseTimer` on a CUDA device ends every phase with
``torch.cuda.synchronize(device)``: the wall clock then covers the work,
not its enqueue.  The line format is the JAX package's, so the two
command lines' logs differ only in their times.
"""
from __future__ import annotations

import sys
import time
from contextlib import contextmanager

import torch

_COLORS = {"info": "\033[32m", "time": "\033[36m", "warn": "\033[33m",
           "err": "\033[31m"}
_RESET = "\033[0m"


def _tag(kind: str) -> str:
    t = f"[{kind}]"
    return f"{_COLORS.get(kind, '')}{t}{_RESET}" if sys.stderr.isatty() \
        else t


def print_info(label: str, value=None, width: int = 42) -> None:
    msg = f"{_tag('info')} {label:<{width}}"
    if value is not None:
        msg += f" : {value}"
    print(msg, file=sys.stderr)


def print_warn(msg: str) -> None:
    print(f"{_tag('warn')} {msg}", file=sys.stderr)


class PhaseTimer:
    """Named accumulating wall-clock timers.  ``device``: where the timed
    work runs; on a CUDA device each phase ends with a synchronize."""

    def __init__(self, enabled: bool = True,
                 device: torch.device | str | None = None):
        self.enabled = enabled
        self.device = None if device is None else torch.device(device)
        self.times: dict[str, float] = {}
        self.counts: dict[str, int] = {}

    def _sync(self) -> None:
        if self.device is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextmanager
    def phase(self, name: str):
        if not self.enabled:
            yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.toc(name, t0)

    def tic(self) -> float:
        return time.perf_counter()

    def toc(self, name: str, t0: float) -> float:
        self._sync()
        dt = time.perf_counter() - t0
        self.times[name] = self.times.get(name, 0.0) + dt
        self.counts[name] = self.counts.get(name, 0) + 1
        return dt

    def report(self) -> None:
        for name, t in self.times.items():
            label = f"{name} (x{self.counts[name]})"
            print(f"{_tag('time')} {label:<42} : {t:.6f} s", file=sys.stderr)
