"""The device trace of a traced run: ``torch.profiler`` (CUDA activity
only, so the host loop is not slowed by recording its operators) over a
slice of the measured window.

The slice is started and stopped from the program's own loop: the
serving entry point takes an injectable clock and calls it on its main
thread several times a loop, and :class:`SliceClock` is that clock
(``time.perf_counter``) with the profiler switched on at ``start_s`` into
the window and off ``length_s`` later.  A training window calls
:meth:`SliceClock.__call__` between its steps.

At the start, at calls of the clock while the slice runs (at most one
each ``MARK_EVERY_S``, so a slice launches a bounded number), and at the
stop, a marker kernel (``torch.cuda._sleep``) is launched and the host
clock read beside its launch.  The program calls its clock right after a
device sync, so a marker runs as soon as it is launched: the offset
between a marker's host reading and its start on the device maps the
trace's time base onto ``time.perf_counter``, so that device operations
can be set against the program's spans (``repro_torch.obs``,
perf_counter microseconds).  The trace does not keep every marker (the
first after the start is often lost), so the markers it kept are paired
with the host readings in launch order (see :func:`align`).
"""

from __future__ import annotations

import dataclasses
import json
import os
import tempfile
import time

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
MARKER = "spin_kernel"
#: a marker's length in clock cycles (about half a microsecond)
MARK_CYCLES = 1000
#: the least host time between two markers inside the slice
MARK_EVERY_S = 0.1
#: the width of the window within which readings and markers agree
ALIGN_US = 50.0


def warm_profiler() -> None:
    """Start and stop the CUDA profiler once, so that the first start
    inside a window does not pay for initialising it."""
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CUDA])
    prof.start()
    torch.cuda._sleep(1000)
    torch.cuda.synchronize()
    prof.stop()
    prof.events()


class SliceClock:
    def __init__(self, start_s: float, length_s: float):
        self.start_s = start_s
        self.length_s = length_s
        self.t0: float | None = None
        self.prof = None
        self.marks: list[float] = []       # perf_counter µs at each marker
        self.on_us: float | None = None
        self.off_us: float | None = None
        #: perf_counter µs intervals in which the loop was held up by
        #: switching the profiler (the stop flushes its buffers)
        self.switches: list[tuple[float, float]] = []

    def _mark(self) -> None:
        self.marks.append(time.perf_counter() * 1e6)
        torch.cuda._sleep(MARK_CYCLES)

    def __call__(self) -> float:
        t = time.perf_counter()
        if self.t0 is None:
            self.t0 = t
        if self.prof is None and t - self.t0 >= self.start_s:
            self.prof = torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA])
            self.prof.start()
            torch.cuda.synchronize()
            self.on_us = time.perf_counter() * 1e6
            self._mark()
            self.switches.append((t * 1e6, time.perf_counter() * 1e6))
        elif self.prof is not None and self.off_us is None:
            if t - self.t0 >= self.start_s + self.length_s:
                self.stop()
            elif 1e6 * t - self.marks[-1] >= 1e6 * MARK_EVERY_S:
                self._mark()
        return t

    def stop(self) -> None:
        if self.prof is None or self.off_us is not None:
            return
        t = time.perf_counter()
        self._mark()
        torch.cuda.synchronize()
        self.off_us = time.perf_counter() * 1e6
        self.prof.stop()
        self.switches.append((t * 1e6, time.perf_counter() * 1e6))

    def read(self) -> "DeviceTrace | None":
        """Parse the slice (None when it never started)."""
        if self.prof is None:
            return None
        self.stop()
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.unlink(path)
        self.prof = None
        return DeviceTrace.from_events(events, self.marks, self.on_us,
                                       self.off_us)


def align(marks, spins) -> tuple[bool, float]:
    """(found, shift): pair the markers the trace kept with the host
    readings ``marks`` in launch order, and map device time onto the host
    clock by the pairs.

    ``spins`` are the kept markers in launch order, each ``(device start,
    launch)``: the launch is the host call's time on the trace's clock
    (None where the trace has no runtime event for it).  The first kept
    marker is tried against each reading in turn; each later marker takes
    the next reading that lies, by the same offset, within ``ALIGN_US``
    of it.  The launches sit a fixed few microseconds after their
    readings, so the right pairing is the one that pairs the most; device
    starts stray by up to milliseconds from their launches, and are the
    key only where a launch is missing.  The pairing is found when it
    pairs at least two markers and no other pairs as many (or the trace
    kept one marker of one reading); the shift is the largest (reading −
    device start) of its pairs, that of a marker that did not wait."""
    if not marks or not spins:
        return False, 0.0
    launched = all(launch is not None for _, launch in spins)
    key = [launch if launched else start for start, launch in spins]
    best, ties = [], 0
    for j in range(len(marks) - len(spins) + 1):
        off, r, pairs = marks[j] - key[0], j + 1, [(j, 0)]
        for k in range(1, len(spins)):
            t = key[k] + off
            while r < len(marks) and marks[r] < t - ALIGN_US:
                r += 1
            if r < len(marks) and abs(marks[r] - t) <= ALIGN_US:
                pairs.append((r, k))
                r += 1
        if len(pairs) > len(best):
            best, ties = pairs, 1
        elif len(pairs) == len(best):
            ties += 1
    found = ((len(best) >= 2 and ties == 1)
             or (len(marks) == 1 and len(spins) == 1))
    return found, max(marks[r] - spins[k][0] for r, k in best)


@dataclasses.dataclass
class Op:
    name: str
    start: float       # perf_counter µs (device execution)
    dur: float         # µs
    launch: float | None   # perf_counter µs of the host launch


@dataclasses.dataclass
class DeviceTrace:
    ops: list[Op]
    on_us: float
    off_us: float
    aligned: bool

    @property
    def window_s(self) -> float:
        return (self.off_us - self.on_us) / 1e6

    @classmethod
    def from_events(cls, events, marks, on_us, off_us) -> "DeviceTrace":
        runtime = {}
        for e in events:
            if e.get("cat") == "cuda_runtime" and "correlation" in e.get(
                    "args", {}):
                runtime[e["args"]["correlation"]] = e["ts"]
        dev = [e for e in events
               if e.get("cat") in DEVICE_CATS and e.get("ph") == "X"]
        spins = sorted((e.get("args", {}).get("correlation", 0), e["ts"],
                        runtime.get(e.get("args", {}).get("correlation")))
                       for e in dev if MARKER in e["name"])
        aligned, shift = align(marks, [(ts, launch)
                                       for _, ts, launch in spins])
        ops = []
        for e in dev:
            if MARKER in e["name"]:
                continue
            launch = runtime.get(e.get("args", {}).get("correlation"))
            ops.append(Op(e["name"], e["ts"] + shift, float(e["dur"]),
                          None if launch is None else launch + shift))
        if not aligned and ops:
            # unaligned: take the trace's own first and last device times
            on_us = min(o.start for o in ops)
            off_us = max(o.start + o.dur for o in ops)
        return cls(ops, on_us, off_us, aligned)

    def busy_intervals(self) -> list[tuple[float, float]]:
        iv = sorted((max(o.start, self.on_us),
                     min(o.start + o.dur, self.off_us)) for o in self.ops)
        out: list[list[float]] = []
        for a, b in iv:
            if b <= a:
                continue
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return [(a, b) for a, b in out]

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) / 1e6

    def top_ops(self, n: int = 10) -> list[list]:
        tot: dict[str, float] = {}
        for o in self.ops:
            tot[o.name] = tot.get(o.name, 0.0) + o.dur / 1e6
        return [[k, v] for k, v in sorted(tot.items(),
                                          key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, spans, n: int = 10) -> list[list]:
        """The ``n`` longest gaps with no device operation, each named by
        the program span open on the host at its middle."""
        busy = self.busy_intervals()
        edges = [self.on_us] + [x for iv in busy for x in iv] + [self.off_us]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        gaps.sort(key=lambda g: g[0] - g[1])
        out = []
        for a, b in gaps[:n]:
            label = "no program span" if self.aligned else "unaligned"
            if self.aligned:
                mid = (a + b) / 2
                inner = [s for s in spans if s["ts"] <= mid <= s["ts"] + s["dur"]]
                if inner:
                    label = min(inner, key=lambda s: s["dur"])["name"]
            out.append([label, (b - a) / 1e6])
        return out

    def ops_in(self, span, names) -> list[Op]:
        """Device ops named by any of ``names`` that ``span`` launched
        (by host launch time; by device time when unaligned)."""
        a, b = span["ts"], span["ts"] + span["dur"]
        out = []
        for o in self.ops:
            if not any(k in o.name for k in names):
                continue
            t = o.launch if o.launch is not None else o.start + o.dur / 2
            if a <= t <= b:
                out.append(o)
        return out

    def covers(self, span) -> bool:
        return (self.aligned and span["ts"] >= self.on_us
                and span["ts"] + span["dur"] <= self.off_us)
