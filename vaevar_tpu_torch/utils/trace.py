"""Spans and counters at the port's layer boundaries, on the clock of a
torch profiler trace.

- `span(name, request=None, device=False, **attrs)`: a context manager
  around one layer's work. While tracing is off (the default) it is one
  check of a module flag that returns a shared no-op context: it records
  nothing, keeps nothing, makes no CUDA event and never waits for the
  device. While on, it records its name, start and end, its id, its
  parent's id (the innermost span open on the same thread), the thread's
  name, the request id (a DA cycle's index or a train step's: given, or
  else the parent's) and `attrs`. With `device=True`, once CUDA is
  initialised, it also records a timing event on the current stream at
  entry and at exit; `records()` resolves the pair to `device_ms`, the
  device time between them, so nothing waits while the span runs.
- `count(name, n=1)`: adds to a counter. Counters are always on; they count
  at eval, probe, sync or step granularity, never per kernel, but for the
  LGUnet's held weight copies (models/lgunet.py): `lgunet.cast_held`, one
  per cast a call spares, and `lgunet.cast_made`, one per copy made.
- `tallied()`: the work a CUDA graph captures (da/graphs.py) runs its
  Python once, at the capture, and never at a replay. Inside the block,
  what counts on a capturing stream (utils/capture.py::capturing, on any
  thread: a captured backward runs on the autograd engine's) goes to the
  yielded `Tally` and not to the counters, a host span there records
  nothing, and a device span records a pair of external timing events into
  the graph and the tally, whether tracing is on or off. After each replay,
  `Tally.replayed()` adds the tally to the counters, so a replay counts
  what one eager run of its body counts, and while tracing is on records
  each of those device spans, closed, with the `device_ms` its events read
  on that replay.
- `enable()` (which also drops the spans kept so far), `disable()`,
  `enabled()`, `records()` (the closed spans, oldest first), `counters()`
  and `write_jsonl(path)`: one JSON object a line, each span's record, then
  `{"counters": {...}}`. `exported(path)` is the CLIs' `--spans`: tracing on
  for a block, and the file written at its end.

The clock: host stamps are `time.perf_counter_ns()`. `enable()` and
`records()` each read it with `time.time_ns()`, and `records()` maps every
stamp onto `time_ns` along the line through the two readings. `time_ns` is
the clock of a torch profiler's Chrome trace (an event's `ts` in us plus
the trace's `baseTimeNanoseconds`), so a span lies over the device work
that the profiler saw the host launch inside it.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import threading
import time

import torch

from vaevar_tpu_torch.utils import capture

_NOOP = contextlib.nullcontext()
_on = False
_spans: list = []
_ids = itertools.count(1)
_local = threading.local()
_anchor = (0, 0)  # (perf_counter_ns, time_ns) at enable()
_counters: dict = {}
_counters_lock = threading.Lock()
_tally = None  # the Tally of the capture open now (tallied), or None


def _clocks():
    """(perf_counter_ns, time_ns) read together: the mean of two perf
    readings around one time reading."""
    p0 = time.perf_counter_ns()
    t = time.time_ns()
    return (p0 + time.perf_counter_ns()) // 2, t


def enable():
    """Record spans from now on; the spans kept so far are dropped."""
    global _on, _anchor
    _spans.clear()
    _anchor = _clocks()
    _on = True


def disable():
    """Record no more spans; those open now still record their end."""
    global _on
    _on = False


def enabled() -> bool:
    return _on


def count(name: str, n: int = 1):
    tally = _tally
    into = tally.counts if tally is not None and capture.capturing() else _counters
    with _counters_lock:
        into[name] = into.get(name, 0) + n


def counters() -> dict:
    """A copy of every counter of this process."""
    with _counters_lock:
        return dict(_counters)


def span(name: str, request=None, device: bool = False, **attrs):
    tally = _tally
    if tally is not None and capture.capturing():
        return _Captured(tally, name, attrs) if device else _NOOP
    if not _on:
        return _NOOP
    return _Span(name, request, device, attrs)


class Tally:
    """What one run of a body captured into a CUDA graph counts (`counts`)
    and its device spans (`spans`: name, attrs and the pair of external
    timing events the graph records at each replay)."""

    def __init__(self):
        self.counts: dict = {}
        self.spans: list = []

    def replayed(self):
        """After a replay: the counts added to the counters and, while
        tracing is on, each device span recorded, closed, as a child of
        this thread's innermost open span, its `device_ms` read from this
        replay's events (waiting for them) and its host stamps now."""
        for name, n in self.counts.items():
            count(name, n)
        if not _on:
            return
        for name, attrs, start, end in self.spans:
            end.synchronize()
            s = _Span(name, None, False, attrs)
            with s:
                pass
            s.ms = start.elapsed_time(end)


@contextlib.contextmanager
def tallied():
    """The Tally of the work captured inside the block (see the module
    docstring); one capture at a time."""
    global _tally
    _tally = Tally()
    try:
        yield _tally
    finally:
        _tally = None


class _Captured:
    """A device span inside a capture: external timing events recorded into
    the graph at entry and exit, kept in the tally."""

    __slots__ = ("tally", "name", "attrs", "events")

    def __init__(self, tally, name, attrs):
        self.tally, self.name, self.attrs = tally, name, attrs

    def __enter__(self):
        self.events = tuple(torch.cuda.Event(enable_timing=True, external=True)
                            for _ in range(2))
        self.events[0].record()
        return self

    def __exit__(self, *exc):
        self.events[1].record()
        with _counters_lock:
            self.tally.spans.append((self.name, self.attrs, *self.events))
        return False


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _Span:
    __slots__ = ("name", "request", "device", "attrs", "id", "parent", "thread", "start",
                 "end", "events", "ms")

    def __init__(self, name, request, device, attrs):
        self.name, self.request, self.device, self.attrs = name, request, device, attrs
        self.end = self.events = self.ms = None

    def __enter__(self):
        stack = _stack()
        parent = stack[-1] if stack else None
        self.id = next(_ids)
        self.parent = parent.id if parent is not None else None
        if self.request is None and parent is not None:
            self.request = parent.request
        self.thread = threading.current_thread().name
        stack.append(self)
        _spans.append(self)
        self.start = time.perf_counter_ns()
        if self.device and torch.cuda.is_initialized():
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
            self.events[0].record()
        return self

    def __exit__(self, *exc):
        if self.events is not None:
            self.events[1].record()
        self.end = time.perf_counter_ns()
        stack = _stack()
        if stack and stack[-1] is self:
            stack.pop()
        elif self in stack:
            stack.remove(self)
        return False


def records() -> list:
    """The closed spans, oldest first, each {"name", "id", "parent",
    "thread", "request", "start_ns", "end_ns" (on the time_ns clock),
    "device_ms" (None but for a device span on CUDA, a replayed one's
    included), "attrs"}. Waits for the device spans' end events."""
    p0, t0 = _anchor
    p1, t1 = _clocks()
    rate = (t1 - t0) / (p1 - p0) if p1 > p0 else 1.0

    def wall(ns):
        return t0 + round((ns - p0) * rate)

    out = []
    for s in list(_spans):
        if s.end is None:
            continue
        device_ms = s.ms
        if s.events is not None:
            s.events[1].synchronize()
            device_ms = s.events[0].elapsed_time(s.events[1])
        out.append({"name": s.name, "id": s.id, "parent": s.parent, "thread": s.thread,
                    "request": s.request, "start_ns": wall(s.start), "end_ns": wall(s.end),
                    "device_ms": device_ms, "attrs": s.attrs})
    return out


def write_jsonl(path):
    """The closed spans, one JSON object a line, then the counters."""
    with open(path, "w") as f:
        for r in records():
            f.write(json.dumps(r) + "\n")
        f.write(json.dumps({"counters": counters()}) + "\n")


@contextlib.contextmanager
def exported(path):
    """With a path, tracing on for the block and its spans and counters
    written there at its end (rank r > 0 of a torch.distributed run writes
    `<path>.rank<r>`); with None, nothing."""
    if path is None:
        yield
        return
    enable()
    try:
        yield
    finally:
        disable()
        dist = torch.distributed
        rank = dist.get_rank() if dist.is_available() and dist.is_initialized() else 0
        write_jsonl(path if rank == 0 else f"{path}.rank{rank}")
