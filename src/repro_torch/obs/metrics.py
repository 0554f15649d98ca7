"""Thread-safe metric primitives — the measurement half of
``repro_torch.obs`` (copy of ``repro.obs.metrics``; stdlib only).

Three metric kinds behind one :class:`Registry`:

* :class:`Counter` — monotonically increasing float/int accumulator;
* :class:`Gauge` — last-written value (queue depth, pool occupancy);
* :class:`Histogram` — streaming distribution with bounded-relative-error
  quantiles: values land in geometric buckets of growth ``GROWTH``
  (≈9%/bucket), so any reported quantile is within a factor ``GROWTH`` of
  the true order statistic — the invariant the hypothesis property tests
  pin.  Exact ``min``/``max``/``sum``/``count`` ride along.

Registries are *near-free when disabled*: every mutator's first action is
one attribute check on the owning registry, so a disabled registry costs
an attribute load + branch per call site and records nothing.  The
module-level :data:`REGISTRY` is the default sink for instrumentation
and starts disabled unless the ``REPRO_OBS`` environment variable is set
(how spawned workers inherit the session's obs state); subsystems whose
counters are load-bearing create private always-enabled registries
instead.
"""

from __future__ import annotations

import math
import os
import threading
import weakref
from typing import Sequence

#: geometric bucket growth: quantiles are exact within this factor
GROWTH = 2.0 ** 0.125            # ≈ 1.0905 → ≤ ~9% relative error
_LOG_G = math.log(GROWTH)
#: lower edge of bucket 0 — values at or below land in the floor bucket
#: and report the exact observed minimum (1 ns in seconds units)
FLOOR = 1e-9

#: every live registry, for whole-process snapshots (weak: a registry
#: dies with its owner — e.g. a closed table's telemetry)
_REGISTRIES: "weakref.WeakSet[Registry]" = weakref.WeakSet()
_REG_LOCK = threading.Lock()


def env_enabled() -> bool:
    """Initial enabled state: the ``REPRO_OBS`` env var (``1``/``true``).
    Spawned worker processes inherit it, which is how a shard server
    knows the parent session configured observability."""
    return os.environ.get("REPRO_OBS", "").lower() in ("1", "true", "on")


class Counter:
    """Monotonic accumulator (float adds, so fractional seconds work)."""

    __slots__ = ("_reg", "_lock", "_v")

    def __init__(self, registry: "Registry"):
        self._reg = registry
        self._lock = threading.Lock()
        self._v = 0.0

    def inc(self, n: float = 1.0) -> None:
        if not self._reg.enabled:
            return
        with self._lock:
            self._v += n

    @property
    def value(self) -> float:
        return self._v

    def snapshot(self) -> dict:
        return {"value": self._v}


class Gauge:
    """Last-written value."""

    __slots__ = ("_reg", "_v")

    def __init__(self, registry: "Registry"):
        self._reg = registry
        self._v = 0.0

    def set(self, v: float) -> None:
        if not self._reg.enabled:
            return
        self._v = float(v)

    @property
    def value(self) -> float:
        return self._v

    def snapshot(self) -> dict:
        return {"value": self._v}


class Histogram:
    """Streaming distribution over positive values (latencies, sizes).

    Values fall into geometric buckets ``[FLOOR·G^i, FLOOR·G^(i+1))``;
    :meth:`quantile` walks the cumulative counts to the requested rank
    and returns the bucket's geometric midpoint clamped to the exact
    observed ``[min, max]`` — guaranteed within a factor :data:`GROWTH`
    of the true order statistic (values ≤ :data:`FLOOR` are floored and
    report the exact minimum).
    """

    __slots__ = ("_reg", "_lock", "_buckets", "count", "total",
                 "_min", "_max")

    def __init__(self, registry: "Registry"):
        self._reg = registry
        self._lock = threading.Lock()
        self._buckets: dict[int, int] = {}
        self.count = 0
        self.total = 0.0
        self._min = math.inf
        self._max = -math.inf

    @staticmethod
    def bucket_of(v: float) -> int:
        if v <= FLOOR:
            return -1                     # floor bucket
        return int(math.log(v / FLOOR) // _LOG_G)

    def record(self, v: float) -> None:
        if not self._reg.enabled:
            return
        v = float(v)
        b = self.bucket_of(v)
        with self._lock:
            self._buckets[b] = self._buckets.get(b, 0) + 1
            self.count += 1
            self.total += v
            if v < self._min:
                self._min = v
            if v > self._max:
                self._max = v

    @property
    def min(self) -> float:
        return self._min if self.count else 0.0

    @property
    def max(self) -> float:
        return self._max if self.count else 0.0

    def quantile(self, q: float) -> float:
        """Value at quantile ``q`` ∈ [0, 1] (within a factor GROWTH)."""
        with self._lock:
            if not self.count:
                return 0.0
            if q <= 0.0:
                return self._min
            if q >= 1.0:
                return self._max
            # rank of the order statistic ceil(q·n) (1-based), 0-indexed
            rank = min(self.count - 1, max(0, math.ceil(q * self.count) - 1))
            cum = 0
            for b in sorted(self._buckets):
                cum += self._buckets[b]
                if cum > rank:
                    if b < 0:
                        return self._min   # floored values: min is exact
                    est = FLOOR * math.exp((b + 0.5) * _LOG_G)
                    return min(max(est, self._min), self._max)
            return self._max               # unreachable, defensively

    def percentiles(self) -> dict:
        return {"p50": self.quantile(0.50), "p95": self.quantile(0.95),
                "p99": self.quantile(0.99)}

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def snapshot(self) -> dict:
        with self._lock:
            count, total = self.count, self.total
        return {"count": count, "sum": total,
                "mean": total / count if count else 0.0,
                "min": self.min, "max": self.max, **self.percentiles()}


_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class Registry:
    """Get-or-create store of named, labeled metrics.

    ``enabled`` gates every mutator of every owned metric: a disabled
    registry's counters/gauges/histograms record nothing and cost one
    branch per call.  Reads (``snapshot``/``value``) always work.
    """

    def __init__(self, name: str = "default", *, enabled: bool = True):
        self.name = name
        self.enabled = enabled
        #: set by :meth:`close` when the owning subsystem shuts down —
        #: live-state aggregators (``bridge._ps_traffic``) skip closed
        #: registries so a finished client's cumulative traffic can't
        #: bleed into a later snapshot's bandwidths; whole-run exports
        #: (``snapshot_all``) still include them as history
        self.closed = False
        self._lock = threading.Lock()
        #: (kind, name, labels-tuple) → metric
        self._metrics: dict[tuple, object] = {}
        with _REG_LOCK:
            _REGISTRIES.add(self)

    def close(self) -> None:
        """Mark this registry as belonging to a shut-down owner.  Reads
        keep working (history), but :func:`live_registries` — and with it
        the live-metrics bridge — stops aggregating it.  Idempotent."""
        self.closed = True

    # --- get-or-create ---------------------------------------------------
    def _get(self, kind: str, name: str, labels: dict):
        key = (kind, name, tuple(sorted(labels.items())))
        with self._lock:
            m = self._metrics.get(key)
            if m is None:
                clash = next((k for k in self._metrics
                              if k[1] == name and k[0] != kind), None)
                if clash is not None:
                    raise TypeError(
                        f"metric {name!r} already registered as {clash[0]}")
                m = self._metrics[key] = _KINDS[kind](self)
        return m

    def counter(self, name: str, **labels) -> Counter:
        return self._get("counter", name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get("gauge", name, labels)

    def histogram(self, name: str, **labels) -> Histogram:
        return self._get("histogram", name, labels)

    # --- reads -----------------------------------------------------------
    def find(self, name: str) -> list[tuple[dict, object]]:
        """All (labels, metric) pairs registered under ``name``."""
        with self._lock:
            return [(dict(k[2]), m) for k, m in self._metrics.items()
                    if k[1] == name]

    def value(self, name: str, default: float = 0.0, **labels) -> float:
        key_labels = tuple(sorted(labels.items()))
        with self._lock:
            for (kind, n, lab), m in self._metrics.items():
                if n == name and lab == key_labels and kind != "histogram":
                    return m.value
        return default

    def snapshot(self) -> list[dict]:
        with self._lock:
            items = list(self._metrics.items())
        return [{"name": name, "type": kind, "labels": dict(labels),
                 **m.snapshot()}
                for (kind, name, labels), m in sorted(
                    items, key=lambda kv: (kv[0][1], kv[0][2]))]

    def reset(self) -> None:
        with self._lock:
            self._metrics.clear()


def all_registries() -> list[Registry]:
    with _REG_LOCK:
        return sorted(_REGISTRIES, key=lambda r: r.name)


def live_registries() -> list[Registry]:
    """Every registry whose owner has not been closed — the set
    *current-state* aggregation (the cost-model bridge) must use, as
    opposed to whole-run exports which want closed history too."""
    return [r for r in all_registries() if not r.closed]


def merge_histograms(hists: Sequence[Histogram]) -> dict:
    """One :meth:`Histogram.snapshot`-shaped dict over the union of
    several histograms' samples, as if every value had been recorded into
    a single histogram (bucket counts add; the quantile walk is the same
    as :meth:`Histogram.quantile`, so the GROWTH error bound holds
    against the pooled sample).  The aggregation fix for ``find()``
    matching multiple labeled histograms under one metric name."""
    buckets: dict[int, int] = {}
    count, total = 0, 0.0
    mn, mx = math.inf, -math.inf
    for h in hists:
        with h._lock:
            for b, n in h._buckets.items():
                buckets[b] = buckets.get(b, 0) + n
            count += h.count
            total += h.total
            mn = min(mn, h._min)
            mx = max(mx, h._max)
    if not count:
        return {"count": 0, "sum": 0.0, "mean": 0.0, "min": 0.0, "max": 0.0,
                "p50": 0.0, "p95": 0.0, "p99": 0.0}

    def quantile(q: float) -> float:
        if q <= 0.0:
            return mn
        if q >= 1.0:
            return mx
        rank = min(count - 1, max(0, math.ceil(q * count) - 1))
        cum = 0
        for b in sorted(buckets):
            cum += buckets[b]
            if cum > rank:
                if b < 0:
                    return mn
                est = FLOOR * math.exp((b + 0.5) * _LOG_G)
                return min(max(est, mn), mx)
        return mx

    return {"count": count, "sum": total, "mean": total / count,
            "min": mn, "max": mx, "p50": quantile(0.50),
            "p95": quantile(0.95), "p99": quantile(0.99)}


def snapshot_all() -> dict:
    """``{registry_name: snapshot}`` over every live registry (named
    collisions merge under one key in creation order)."""
    out: dict[str, list] = {}
    for reg in all_registries():
        snap = reg.snapshot()
        if not snap:
            continue
        out.setdefault(reg.name, []).extend(snap)
    return out


#: default sink for optional instrumentation (serve/train/client spans'
#: metric twins) — disabled unless the session configured observability
REGISTRY = Registry("default", enabled=env_enabled())
