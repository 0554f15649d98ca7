"""Span tracing — ring-buffered events exported as Chrome trace JSON
(copy of ``repro.obs.trace``; stdlib only).

Events follow the Chrome trace-event format (load the exported file in
Perfetto / ``chrome://tracing``):

* :func:`span` — a ``with``-scoped complete event (``ph="X"``) carrying
  wall duration, pid/tid lanes and arbitrary JSON-safe args;
* :func:`instant` — a zero-duration marker (``ph="i"``) for lifecycle
  events (admissions, preemptions, evictions);
* :class:`TraceBuffer` — bounded ring of event dicts.  The process-global
  :data:`BUFFER` backs the main timeline; a buffer collected from another
  process merges into it as a distinct process lane.

Timestamps are ``time.perf_counter_ns()`` microseconds.  On Linux that
clock is CLOCK_MONOTONIC, which is system-wide: events recorded in
different processes on one machine share a timeline.

Enabled state mirrors :mod:`repro_torch.obs.metrics`: off by default,
flipped by ``repro_torch.obs.configure`` (which also sets ``REPRO_OBS`` so
workers spawned afterwards inherit it).  Disabled, :func:`span` returns a
shared no-op context manager — one branch + no allocation.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque

from repro_torch.obs import metrics as _metrics

#: default ring capacity — bounds trace memory on long runs (oldest
#: events fall off; a serve/train session keeps the recent window)
DEFAULT_CAPACITY = 65536

_enabled = _metrics.env_enabled()


def enabled() -> bool:
    return _enabled


def set_enabled(flag: bool) -> None:
    global _enabled
    _enabled = bool(flag)


def now_us() -> float:
    return time.perf_counter_ns() / 1e3


class TraceBuffer:
    """Bounded, thread-safe ring of Chrome trace-event dicts."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        self._events: deque = deque(maxlen=capacity)
        self._lock = threading.Lock()

    def add(self, event: dict) -> None:
        with self._lock:
            self._events.append(event)

    def extend(self, events) -> None:
        with self._lock:
            self._events.extend(events)

    def events(self) -> list[dict]:
        with self._lock:
            return list(self._events)

    def drain(self) -> list[dict]:
        with self._lock:
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


class _Span:
    __slots__ = ("name", "cat", "args", "buf", "t0")

    def __init__(self, name, cat, buf, args):
        self.name = name
        self.cat = cat
        self.buf = buf
        self.args = args

    def __enter__(self):
        self.t0 = now_us()
        return self

    def __exit__(self, *exc):
        t1 = now_us()
        self.buf.add({
            "name": self.name, "cat": self.cat, "ph": "X",
            "ts": self.t0, "dur": t1 - self.t0,
            "pid": os.getpid(), "tid": threading.get_native_id(),
            "args": self.args,
        })
        return False


def span(name: str, cat: str = "repro", *, buffer: TraceBuffer | None = None,
         **args):
    """``with span("serve.prefill", rid=3): ...`` — records a complete
    event on exit.  Near-free when disabled (shared no-op object)."""
    if not _enabled:
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


def chrome_trace(events: list[dict]) -> dict:
    """Wrap merged events in the Chrome trace-event envelope."""
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def write_chrome(path: str, *event_lists) -> str:
    """Merge ``event_lists`` (default: the global buffer) and write a
    Perfetto-loadable Chrome trace JSON.  Returns the path."""
    if not event_lists:
        event_lists = (BUFFER.events(),)
    with open(path, "w") as f:
        json.dump(chrome_trace(merged(*event_lists)), f, default=str)
    return path
