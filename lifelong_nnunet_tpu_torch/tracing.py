"""Spans and counters inside the port, recorded in memory while a recording
is open.

Off by default.  ``recording()`` switches recording on for its body and
yields the :class:`Recording`; one may be open at a time in a process.
Off, ``span(...)`` returns one shared no-op context object after a single
module-global check and ``count(...)`` returns after the same check:
nothing is allocated, no CUDA event is made and no clock is read.

``span(name, *, device=False, **ids)`` records its name, its start and end
on ``time.perf_counter_ns()``, its thread, its own id, the id of its parent
(the innermost span open on the same thread) and its request identifiers:
``ids`` over those of its parent, so the children of a span that carries a
case or a step carry it too.  With ``device=True``, where this process uses
CUDA, the span also records a CUDA event on the current stream at entry and
at exit; the recording reads the card's milliseconds between the two
(``device_ms``) when it closes.  ``device_ms`` is None elsewhere.

``count(name, n=1)`` adds to a named integer counter.

The recording takes one ``(time.time_ns(), time.perf_counter_ns())`` pair
when it opens: :meth:`Recording.on_trace` maps its spans onto the timeline
of a ``torch.profiler`` trace, whose device and host activity is in Unix
nanoseconds from the trace's start (``kineto_results.trace_start_ns()``).
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time

import torch

_recording = None            # the open Recording, or None
_opening = threading.Lock()


class _Off:
    """The context object of every span while nothing records."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


OFF = _Off()


class Span:
    """One recorded span; ``start_ns`` / ``end_ns`` on ``perf_counter_ns``."""

    __slots__ = ("rec", "name", "id", "parent", "thread", "ids", "start_ns", "end_ns",
                 "events", "device_ms")

    def __init__(self, rec: "Recording", name: str, device: bool, ids: dict):
        self.rec, self.name, self.ids = rec, name, ids
        self.id = next(rec._ids)
        self.events = (torch.cuda.Event(enable_timing=True),
                       torch.cuda.Event(enable_timing=True)) \
            if device and torch.cuda.is_initialized() else None
        self.parent = self.end_ns = self.device_ms = None

    def __enter__(self):
        stack = self.rec._stack()
        if stack:
            top = stack[-1]
            self.parent = top.id
            self.ids = {**top.ids, **self.ids}
        stack.append(self)
        self.thread = threading.get_ident()
        if self.events is not None:
            self.events[0].record()
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        # the clock before the event: recording a new event can take longer
        # than the body
        self.end_ns = time.perf_counter_ns()
        if self.events is not None:
            self.events[1].record()
        self.rec._stack().pop()
        self.rec.spans.append(self)
        return False


class Recording:
    """The spans (in the order they closed) and counters of one recording."""

    def __init__(self):
        self.spans: list = []
        self.counters: dict = {}
        self._ids = itertools.count()
        self._local = threading.local()
        self._count_lock = threading.Lock()
        self.wall_ns, self.perf_ns = time.time_ns(), time.perf_counter_ns()

    def _stack(self) -> list:
        try:
            return self._local.stack
        except AttributeError:
            self._local.stack = []
            return self._local.stack

    def _count(self, name: str, n: int) -> None:
        with self._count_lock:
            self.counters[name] = self.counters.get(name, 0) + int(n)

    def _close(self) -> None:
        for s in self.spans:
            if s.events is not None:
                s.events[1].synchronize()
                s.device_ms = s.events[0].elapsed_time(s.events[1])
                s.events = None

    def unix_ns(self, perf_ns: int) -> int:
        """A ``perf_counter_ns`` reading on the Unix clock."""
        return self.wall_ns + (perf_ns - self.perf_ns)

    def on_trace(self, trace_start_ns: int) -> list:
        """Every span as a dict, its start and end in microseconds from a
        profiler trace's start (``trace_start_ns``, Unix nanoseconds)."""
        return [{"name": s.name, "id": s.id, "parent": s.parent, "thread": s.thread,
                 "ids": dict(s.ids), "device_ms": s.device_ms,
                 "start_us": (self.unix_ns(s.start_ns) - trace_start_ns) / 1e3,
                 "end_us": (self.unix_ns(s.end_ns) - trace_start_ns) / 1e3}
                for s in self.spans]


@contextlib.contextmanager
def recording():
    """Record spans and counters for the body; yields the Recording, whose
    spans have their ``device_ms`` once the body is left."""
    global _recording
    with _opening:
        if _recording is not None:
            raise RuntimeError("a recording is open already")
        rec = _recording = Recording()
    try:
        yield rec
    finally:
        _recording = None
        rec._close()


def span(name: str, *, device: bool = False, **ids):
    rec = _recording
    if rec is None:
        return OFF
    return Span(rec, name, device, ids)


def count(name: str, n: int = 1) -> None:
    rec = _recording
    if rec is None:
        return
    rec._count(name, n)
