"""The port's tracer, phase timers and structured logging.

:class:`PhaseTimer` is the process's one tracer.  The command line uses
it as the reference's wall-clock ``TicToc`` timers: CUDA launches return
before the card has finished, so a phase (:meth:`PhaseTimer.phase`) on a
CUDA device ends with ``torch.cuda.synchronize(device)`` and its wall
clock covers the work, not its enqueue.  Installed with
:func:`tracing`, it also receives what the program records where the
work happens:

* :func:`span` (``name``, optionally a level index): two stamps of the
  host's clock, no synchronise, kept as ``(name, level, t0, t1)``;
* :func:`count`: a named counter;
* :func:`read`: the one way the program reads a card tensor on the host
  (``.tolist()``, or a numpy array), which counts ``host_reads`` and
  records a ``host_read`` span (or the span its caller names).

A tracer made with ``device_spans`` also records a CUDA event at each
end of every span of those names (no synchronise, never inside a graph
capture): :meth:`PhaseTimer.device_seconds` gives their device time.

With no tracer installed :func:`span` returns one shared no-op context
manager and :func:`count` and :func:`read` do no more than their plain
work: one global load and one comparison each, nothing allocated,
nothing synchronised.

Installed on a CUDA device, a tracer stamps the host's clock and at once
launches a marker kernel (:data:`MARKER_KERNEL`): a device trace taken
around the block is placed on the tracer's clock by its first such
event, to within one launch's latency.  The line format is the JAX
package's, so the two command lines' logs differ only in their times
(and the tracer's own lines).
"""
from __future__ import annotations

import sys
import time
from contextlib import contextmanager

import torch

_COLORS = {"info": "\033[32m", "time": "\033[36m", "warn": "\033[33m",
           "err": "\033[31m"}
_RESET = "\033[0m"

# spans in which the host waits on a device read (counted as host_reads)
READ_SPANS = ("host_read", "krylov.read")
# the name of the marker's kernel in a device trace: a fill of int16
# words, which the program launches nowhere else
MARKER_KERNEL = "FillFunctor<short>"


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


class _NoSpan:
    """The span of a process with no tracer installed."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


NO_SPAN = _NoSpan()
_tracer: "PhaseTimer | None" = None


class _Span:
    __slots__ = ("tracer", "name", "level", "t0")

    def __init__(self, tracer: "PhaseTimer", name: str, level):
        self.tracer, self.name, self.level = tracer, name, level

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.tracer._record(self.name, self.level, self.t0,
                            time.perf_counter())
        return False


class _EventSpan(_Span):
    """A span that also records a CUDA event at each end."""

    __slots__ = ("start",)

    def __enter__(self):
        self.start = torch.cuda.Event(enable_timing=True)
        self.start.record()
        return super().__enter__()

    def __exit__(self, *exc):
        end = torch.cuda.Event(enable_timing=True)
        end.record()
        self.tracer.events.append((self.name, self.level, self.start, end))
        return super().__exit__(*exc)


def _key(name: str, level):
    return name if level is None else (name, level)


def _label(key) -> str:
    return key if isinstance(key, str) else f"{key[0]} {key[1]}"


class PhaseTimer:
    """Named accumulating wall-clock timers, spans and counters.
    ``device``: where the timed work runs; on a CUDA device each phase
    ends with a synchronize, and :func:`tracing` launches its marker
    there.  ``times``/``counts`` hold the total and number of each phase
    and span, keyed by name (``(name, level)`` for a span with a level),
    in the order they first ended; ``records`` every span as ``(name,
    level, t0, t1)``; ``counters`` the counters; ``marker`` the host
    stamp of the last marker launched (None off the card).
    ``device_spans``: span names that also record CUDA events, kept in
    ``events`` as ``(name, level, start, end)`` (on a CUDA device)."""

    def __init__(self, device: torch.device | str | None = None,
                 device_spans: tuple[str, ...] = ()):
        self.device = None if device is None else torch.device(device)
        self.times: dict = {}
        self.counts: dict = {}
        self.records: list[tuple[str, int | None, float, float]] = []
        self.counters: dict[str, int] = {}
        self.marker: float | None = None
        on_card = self.device is not None and self.device.type == "cuda"
        self.device_spans = frozenset(device_spans if on_card else ())
        self.events: list = []

    def _sync(self) -> None:
        if self.device is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextmanager
    def phase(self, name: str):
        """A phase ``name``: its wall clock, ending in a synchronize on a
        CUDA device."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._sync()
            self._add(name, time.perf_counter() - t0)

    def _add(self, key, dt: float) -> None:
        self.times[key] = self.times.get(key, 0.0) + dt
        self.counts[key] = self.counts.get(key, 0) + 1

    def _record(self, name: str, level, t0: float, t1: float) -> None:
        self.records.append((name, level, t0, t1))
        self._add(_key(name, level), t1 - t0)

    def span(self, name: str, level: int | None = None) -> _Span:
        """A span that stamps the host's clock on entry and exit (and
        records a CUDA event at each for a name among ``device_spans``,
        outside a graph capture)."""
        if name in self.device_spans \
                and not torch.cuda.is_current_stream_capturing():
            return _EventSpan(self, name, level)
        return _Span(self, name, level)

    def device_seconds(self, name: str) -> dict:
        """The device time between the two events of every span ``name``
        recorded with events, summed by level (waits for them)."""
        out: dict = {}
        for n, level, start, end in self.events:
            if n == name:
                end.synchronize()
                out[level] = out.get(level, 0.0) \
                    + start.elapsed_time(end) * 1e-3
        return out

    def count(self, name: str, n: int = 1) -> None:
        self.counters[name] = self.counters.get(name, 0) + n

    def mark(self) -> None:
        """Stamp the host's clock and launch the device marker at once,
        one int16 word filled (nothing off the card).  Not the port's
        empty kernel: ``torch.profiler`` kept that in a device trace only
        1-2 times in 8 on the H100, a PyTorch fill every time."""
        if self.device is not None and self.device.type == "cuda":
            self.marker = time.perf_counter()
            torch.full((1,), 1, dtype=torch.int16, device=self.device)

    def spans(self, name: str) -> list[tuple[int | None, float, float]]:
        """``(level, t0, t1)`` of every span ``name``."""
        return [(lv, t0, t1) for n, lv, t0, t1 in self.records if n == name]

    def self_times(self, names=("level", "coarse_solve")) -> dict:
        """The self time of every span among ``names``, summed by key
        (as ``times``): its time less that of the spans among ``names``
        directly inside it."""
        own: dict = {}
        stack: list[list] = []      # [t1, key, t0, child time]

        def close(entry):
            t1, key, t0, child = entry
            own[key] = own.get(key, 0.0) + (t1 - t0) - child

        recs = sorted((r for r in self.records if r[0] in names),
                      key=lambda r: (r[2], -r[3]))
        for name, level, t0, t1 in recs:
            while stack and stack[-1][0] <= t0:
                close(stack.pop())
            if stack:
                stack[-1][3] += t1 - t0
            stack.append([t1, _key(name, level), t0, 0.0])
        while stack:
            close(stack.pop())
        return own

    def report(self) -> None:
        """One ``[time]`` line a phase or span (reads apart), each level's
        self time, the reads' waits, the device time of spans with
        events, then the counters."""
        for key, t in self.times.items():
            if key not in READ_SPANS:
                self._line("time", f"{_label(key)} (x{self.counts[key]})",
                           f"{t:.6f} s")
        own = self.self_times()
        for key in sorted(k for k in own if k[0] == "level"):
            self._line("time", f"{_label(key)} self", f"{own[key]:.6f} s")
        for label in READ_SPANS:
            if label in self.times:
                self._line("read", f"{label} (x{self.counts[label]})",
                           f"{self.times[label]:.6f} s")
        for name in dict.fromkeys(n for n, *_ in self.events):
            for level, t in self.device_seconds(name).items():
                self._line("time", f"{_label(_key(name, level))} (device)",
                           f"{t:.6f} s")
        for name, n in self.counters.items():
            self._line("count", name, n)

    @staticmethod
    def _line(kind: str, label: str, value) -> None:
        print(f"{_tag(kind)} {label:<42} : {value}", file=sys.stderr)


@contextmanager
def tracing(tracer: PhaseTimer):
    """Install ``tracer`` as the process's tracer for the block (and
    launch its device marker)."""
    global _tracer
    prev = _tracer
    tracer.mark()
    _tracer = tracer
    try:
        yield tracer
    finally:
        _tracer = prev


def span(name: str, level: int | None = None):
    """A span ``name`` (at ``level``) on the installed tracer; the
    shared no-op context with none installed."""
    tracer = _tracer
    if tracer is None:
        return NO_SPAN
    return tracer.span(name, level)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the installed tracer's counter ``name``."""
    tracer = _tracer
    if tracer is not None:
        tracer.count(name, n)


def read(t: torch.Tensor, name: str = "host_read", array: bool = False):
    """``t.tolist()`` (a Python number for a 0-d tensor), or with
    ``array`` a numpy array: a card tensor read on the host.  With a
    tracer installed the read is counted as ``host_reads`` and recorded
    as a span ``name``."""
    tracer = _tracer
    if tracer is None:
        return t.cpu().numpy() if array else t.tolist()
    with tracer.span(name):
        out = t.cpu().numpy() if array else t.tolist()
    tracer.count("host_reads")
    return out
