"""Span tracing — ring-buffered events exported as Chrome trace JSON
(grown from ``repro.obs.trace``; stdlib only: importing it loads no torch).

Events follow the Chrome trace-event format (load the exported file in
Perfetto / ``chrome://tracing``):

* :func:`span` — a ``with``-scoped complete event (``ph="X"``) carrying
  wall duration, pid/tid lanes and arbitrary JSON-safe args, plus
  ``args["id"]`` and ``args["parent"]`` (the innermost span open on its
  thread; ids are per process), so self time and ancestry follow;
* :func:`instant` — a zero-duration marker (``ph="i"``) for lifecycle
  events (admissions, preemptions, evictions);
* :class:`TraceBuffer` — bounded ring of event dicts.  The process-global
  :data:`BUFFER` backs the main timeline; a buffer collected from another
  process merges into it as a distinct process lane.

Timestamps are ``time.perf_counter_ns()`` microseconds.  On Linux that
clock is CLOCK_MONOTONIC, which is system-wide: events recorded in
different processes on one machine share a timeline.  The exported
envelope carries a ``clock_anchor`` (``perf_counter_ns`` and ``time_ns``
read together), which places the timeline on unix time, the base of a
``torch.profiler`` trace (its ``baseTimeNanoseconds``).

A span records while obs is enabled — off by default, flipped by
``repro_torch.obs.configure`` (which also sets ``REPRO_OBS`` so workers
spawned afterwards inherit it) — and while a ``torch.profiler`` session
records (``torch.autograd.profiler._is_profiler_enabled``, looked up
only once torch is loaded).  While the profiler records, each span also
enters ``record_function(name)``, so it shows in the profiler's own
trace.  With both off, :func:`span` returns a shared no-op context
manager: one branch, no allocation.

Once the process has initialised CUDA, a recorded span is also timed on
the device: a CUDA event pair on the current stream at entry and exit.
Nothing waits on the hot path; a pair becomes ``args["device_ms"]`` when
the buffer is read (:meth:`TraceBuffer.events`, ``drain``, and so
``flush``), and finished pairs are settled as later spans close, so
pending pairs stay bounded.  Without CUDA no pair is made and
``device_ms`` is absent.  The pair times the stream, not the span's own
work: a span around host-only work in a process that uses CUDA reads
what the stream ran meanwhile.

Parents do not cross threads.  The autograd engine runs a CUDA backward,
and the checkpointed recompute with it, on a thread of its own, where
the spans it opens have no parent; a reader places them under the
backward span whose host interval holds them.
"""

from __future__ import annotations

import itertools
import json
import os
import sys
import threading
import time
from collections import deque

from repro_torch.obs import metrics as _metrics

#: default ring capacity — bounds trace memory on long runs (oldest
#: events fall off; a serve/train session keeps the recent window)
DEFAULT_CAPACITY = 65536
#: device-timed spans whose event pair is not settled yet, per buffer;
#: past this the oldest pair is waited for (it finished long ago)
MAX_PENDING = 4096

_enabled = _metrics.env_enabled()


def enabled() -> bool:
    return _enabled


def set_enabled(flag: bool) -> None:
    global _enabled
    _enabled = bool(flag)


class _ProfilerNotLoaded:
    """Stands in for ``torch.autograd.profiler`` until torch has loaded
    it; then the module itself takes its place."""

    @property
    def _is_profiler_enabled(self) -> bool:
        global _profiler
        mod = sys.modules.get("torch.autograd.profiler")
        if mod is None:
            return False
        _profiler = mod
        return mod._is_profiler_enabled


_profiler = _ProfilerNotLoaded()


def now_us() -> float:
    return time.perf_counter_ns() / 1e3


class TraceBuffer:
    """Bounded, thread-safe ring of Chrome trace-event dicts, with the
    CUDA event pairs of its device-timed spans until they are settled."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        self._events: deque = deque(maxlen=capacity)
        self._pending: deque = deque()     # (event, start, end)
        self._lock = threading.Lock()

    def add(self, event: dict) -> None:
        with self._lock:
            self._events.append(event)

    def add_timed(self, event: dict, start, end) -> None:
        """Add ``event``; its ``args["device_ms"]`` is the time between
        the CUDA events ``start`` and ``end`` once they are settled."""
        with self._lock:
            self._events.append(event)
            self._pending.append((event, start, end))
            self._settle(wait=False)

    def _settle(self, *, wait: bool) -> None:
        # pairs are queued in the order the spans closed, which on one
        # stream is the order their end events complete
        while self._pending:
            event, start, end = self._pending[0]
            if not (wait or len(self._pending) > MAX_PENDING
                    or end.query()):
                return
            end.synchronize()
            event["args"]["device_ms"] = start.elapsed_time(end)
            self._pending.popleft()

    def extend(self, events) -> None:
        with self._lock:
            self._events.extend(events)

    def events(self) -> list[dict]:
        with self._lock:
            self._settle(wait=True)
            return list(self._events)

    def drain(self) -> list[dict]:
        with self._lock:
            self._settle(wait=True)
            out = list(self._events)
            self._events.clear()
        return out

    def __len__(self) -> int:
        return len(self._events)


#: the process-global timeline every un-buffered span lands in
BUFFER = TraceBuffer()


class _NoopSpan:
    __slots__ = ()

    @property
    def args(self):
        # fresh throwaway dict so call sites can annotate span args
        # (`sp.args["dropped"] = n`) without checking the enabled switch
        return {}

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOOP = _NoopSpan()

_ids = itertools.count(1)
#: the spans open on each thread, innermost last
_open = threading.local()


def _cuda_event():
    """A timing CUDA event recorded now on the current stream, or None
    where CUDA is not in use."""
    torch = sys.modules.get("torch")
    if torch is None or not torch.cuda.is_initialized():
        return None
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


class _Span:
    __slots__ = ("name", "cat", "args", "buf", "t0", "ev0", "rf")

    def __init__(self, name, cat, buf, args):
        self.name = name
        self.cat = cat
        self.buf = buf
        self.args = args

    def __enter__(self):
        stack = getattr(_open, "stack", None)
        if stack is None:
            stack = _open.stack = []
        self.args["id"] = next(_ids)
        self.args["parent"] = stack[-1].args["id"] if stack else None
        stack.append(self)
        self.rf = None
        if _profiler._is_profiler_enabled:
            self.rf = _profiler.record_function(self.name)
            self.rf.__enter__()
        self.ev0 = _cuda_event()
        self.t0 = now_us()
        return self

    def __exit__(self, *exc):
        t1 = now_us()
        event = {
            "name": self.name, "cat": self.cat, "ph": "X",
            "ts": self.t0, "dur": t1 - self.t0,
            "pid": os.getpid(), "tid": threading.get_native_id(),
            "args": self.args,
        }
        if self.ev0 is not None:
            self.buf.add_timed(event, self.ev0, _cuda_event())
        else:
            self.buf.add(event)
        if self.rf is not None:
            self.rf.__exit__(*exc)
        _open.stack.remove(self)
        return False


def span(name: str, cat: str = "repro", *, buffer: TraceBuffer | None = None,
         **args):
    """``with span("serve.prefill", rid=3): ...`` — records a complete
    event on exit while obs or a profiler records, timed on the device
    once CUDA is in use (module docstring).  Near-free when not recording
    (shared no-op object)."""
    if not (_enabled or _profiler._is_profiler_enabled):
        return _NOOP
    return _Span(name, cat, buffer if buffer is not None else BUFFER, args)


def instant(name: str, cat: str = "repro", *,
            buffer: TraceBuffer | None = None, **args) -> None:
    """Zero-duration marker (lifecycle events)."""
    if not _enabled:
        return
    (buffer if buffer is not None else BUFFER).add({
        "name": name, "cat": cat, "ph": "i", "s": "p",
        "ts": now_us(),
        "pid": os.getpid(), "tid": threading.get_native_id(),
        "args": args,
    })


def label_process(name: str, *, buffer: TraceBuffer | None = None) -> None:
    """Name this process's pid lane in the merged trace (``ph="M"``)."""
    (buffer if buffer is not None else BUFFER).add({
        "name": "process_name", "ph": "M", "ts": 0,
        "pid": os.getpid(), "tid": threading.get_native_id(),
        "args": {"name": name},
    })


def merged(*event_lists) -> list[dict]:
    """Merge event lists onto one timeline: metadata first, then events
    sorted by timestamp — which makes every (pid, tid) lane monotonic."""
    meta, evs = [], []
    for lst in event_lists:
        for e in lst:
            (meta if e.get("ph") == "M" else evs).append(e)
    evs.sort(key=lambda e: e.get("ts", 0.0))
    return meta + evs


def clock_anchor() -> dict:
    """``perf_counter_ns`` (the spans' clock) and ``time_ns`` (unix time)
    at one instant: the first is the mean of two readings around the
    second."""
    a = time.perf_counter_ns()
    unix = time.time_ns()
    b = time.perf_counter_ns()
    return {"perf_counter_ns": (a + b) // 2, "time_ns": unix}


def chrome_trace(events: list[dict]) -> dict:
    """Wrap merged events in the Chrome trace-event envelope, with the
    :func:`clock_anchor` that maps ``ts`` onto unix time."""
    return {"traceEvents": events, "displayTimeUnit": "ms",
            "clock_anchor": clock_anchor()}


def write_chrome(path: str, *event_lists) -> str:
    """Merge ``event_lists`` (default: the global buffer) and write a
    Perfetto-loadable Chrome trace JSON.  Returns the path."""
    if not event_lists:
        event_lists = (BUFFER.events(),)
    with open(path, "w") as f:
        json.dump(chrome_trace(merged(*event_lists)), f, default=str)
    return path
