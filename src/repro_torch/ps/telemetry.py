"""Per-shard PS traffic accounting, surfaced to the cost model (port of
``repro.ps.telemetry``).

HeterPS's cost model (Formulas 2/5) needs per-stage communication times,
which the analytic profiles derive from nominal ``net_bw``/``ingest_bw``
constants (``core/resources.py``).  The PS subsystem *measures* the real
thing: every pull/push records per-shard rows, bytes and wall time.  Two
bridges feed the measurements back:

* :meth:`PSTelemetry.to_resource` — a ``ResourceType`` whose bandwidth
  terms are replaced by the observed pull/push bandwidths, so fleet
  definitions can be re-anchored to measured PS throughput;
* :meth:`PSTelemetry.embedding_odt` — measured ``(sync, activation)``
  seconds per ``B_o`` profiling window, the shape the cost model's layer
  profiles consume.

Storage is the obs spine: each :class:`PSTelemetry` owns a private
always-enabled :class:`repro_torch.obs.metrics.Registry` (these counters
are load-bearing — the cost-model bridge and the CTR summary read them —
so they record regardless of the session's obs switch), and
:class:`ShardCounters` is a per-shard/per-direction *view* over the
registry's ``ps.ops/rows/bytes/seconds/hot_rows`` counters.  The
arithmetic equals the reference's (pinned in tests/test_torch_ps.py).

Counters are updated from the client's puller/pusher threads; a lock
keeps the row/byte/time triples coherent.
"""

from __future__ import annotations

import dataclasses
import itertools
import threading

import numpy as np

from repro_torch.core.profiles import B_O
from repro_torch.core.resources import ResourceType
from repro_torch.obs import metrics as obs_metrics

#: distinct registry name per telemetry instance — concurrent tables
#: (e.g. the overlap benchmark's sync + async runs) must not collide
_SEQ = itertools.count()


class ShardCounters:
    """Cumulative traffic of one PS shard (one direction) — a view over
    the owning registry's counters."""

    __slots__ = ("_ops", "_rows", "_bytes", "_seconds", "_hot")

    def __init__(self, registry: obs_metrics.Registry, direction: str,
                 shard: int):
        lab = {"dir": direction, "shard": shard}
        self._ops = registry.counter("ps.ops", **lab)
        self._rows = registry.counter("ps.rows", **lab)
        self._bytes = registry.counter("ps.bytes", **lab)
        self._seconds = registry.counter("ps.seconds", **lab)
        self._hot = registry.counter("ps.hot_rows", **lab)

    @property
    def ops(self) -> int:
        return int(self._ops.value)

    @property
    def rows(self) -> int:
        return int(self._rows.value)

    @property
    def bytes(self) -> int:
        return int(self._bytes.value)

    @property
    def seconds(self) -> float:
        """Wall time this shard had an op in flight."""
        return self._seconds.value

    @property
    def hot_rows(self) -> int:
        """Rows served from the DEVICE tier."""
        return int(self._hot.value)

    def add(self, *, ops: int = 0, rows: int = 0, bytes_: int = 0,
            seconds: float = 0.0, hot_rows: int = 0) -> None:
        if ops:
            self._ops.inc(ops)
        if rows:
            self._rows.inc(rows)
        if bytes_:
            self._bytes.inc(bytes_)
        if seconds:
            self._seconds.inc(seconds)
        if hot_rows:
            self._hot.inc(hot_rows)

    def bandwidth(self) -> float:
        secs = self.seconds
        return self.bytes / secs if secs > 0 else 0.0


class PSTelemetry:
    """Pull/push byte + latency accounting for an N-shard table."""

    def __init__(self, num_shards: int, *,
                 registry: obs_metrics.Registry | None = None):
        self.num_shards = num_shards
        #: always-enabled by default: these counters feed the cost model
        #: and benchmarks even when session-wide obs is off
        self.registry = registry if registry is not None else \
            obs_metrics.Registry(f"ps{next(_SEQ)}", enabled=True)
        self._lock = threading.Lock()
        self.pull = [ShardCounters(self.registry, "pull", s)
                     for s in range(num_shards)]
        self.push = [ShardCounters(self.registry, "push", s)
                     for s in range(num_shards)]
        self.events: list[dict] = []

    def ensure(self, num_shards: int) -> None:
        """Grow the per-shard counter lists (elastic fleets add shards at
        runtime; counters for departed shards are kept — traffic history
        stays additive)."""
        with self._lock:
            while self.num_shards < num_shards:
                s = self.num_shards
                self.pull.append(ShardCounters(self.registry, "pull", s))
                self.push.append(ShardCounters(self.registry, "push", s))
                self.num_shards += 1

    def close(self) -> None:
        """Mark the backing registry closed (idempotent).  Called by the
        owning table or fleet on shutdown; reads (``totals``/
        ``shard_report``) keep working as history."""
        self.registry.close()

    def record_event(self, event: dict) -> None:
        """Log one fleet lifecycle event (join/leave/kill/migrate/recover
        dicts from :class:`~repro_torch.ps.elastic.ElasticPSFleet`)."""
        with self._lock:
            self.events.append(dict(event))

    def record(self, op: str, *, rows: np.ndarray, bytes_: np.ndarray,
               seconds: float, hot_rows: np.ndarray | None = None) -> None:
        """Account one pull/push: per-shard ``rows``/``bytes_`` arrays of
        length ``num_shards``; ``seconds`` is the op's wall time, charged
        to every shard the op touched (shard RPCs fly in parallel)."""
        side = self.pull if op == "pull" else self.push
        with self._lock:
            for s in range(min(self.num_shards, len(rows))):
                if rows[s] == 0:
                    continue
                side[s].add(
                    ops=1, rows=int(rows[s]), bytes_=int(bytes_[s]),
                    seconds=seconds,
                    hot_rows=int(hot_rows[s]) if hot_rows is not None else 0)

    # --- reporting ------------------------------------------------------
    def _totals(self, side) -> dict:
        rows = sum(c.rows for c in side)
        bytes_ = sum(c.bytes for c in side)
        secs = max((c.seconds for c in side), default=0.0)
        return {"ops": max((c.ops for c in side), default=0),
                "rows": rows, "bytes": bytes_,
                "seconds": secs,
                "bandwidth": bytes_ / secs if secs > 0 else 0.0,
                "hot_fraction": (sum(c.hot_rows for c in side) / rows
                                 if rows else 0.0)}

    def totals(self) -> dict:
        """Aggregate pull/push traffic.  ``seconds`` is the max over
        shards (shards serve concurrently); bandwidth is effective
        logical-table bandwidth including any simulated RPC latency."""
        return {"pull": self._totals(self.pull),
                "push": self._totals(self.push)}

    def shard_report(self) -> list[dict]:
        out = []
        for s in range(self.num_shards):
            out.append({
                "shard": s,
                "pull_rows": self.pull[s].rows,
                "pull_bytes": self.pull[s].bytes,
                "pull_bw": self.pull[s].bandwidth(),
                "push_rows": self.push[s].rows,
                "push_bytes": self.push[s].bytes,
                "push_bw": self.push[s].bandwidth(),
                "hot_fraction": (self.pull[s].hot_rows / self.pull[s].rows
                                 if self.pull[s].rows else 0.0),
            })
        return out

    # --- cost-model bridges --------------------------------------------
    def to_resource(self, base: ResourceType, *,
                    name_suffix: str = "+ps") -> ResourceType:
        """``base`` with its bandwidth terms replaced by measured PS
        bandwidths: pulls bound data ingest (``ingest_bw``), pull+push
        bound parameter sync (``net_bw``).  Unmeasured terms keep the
        nominal constants."""
        t = self.totals()
        ingest = t["pull"]["bandwidth"]
        net_b = t["pull"]["bytes"] + t["push"]["bytes"]
        net_s = t["pull"]["seconds"] + t["push"]["seconds"]
        net = net_b / net_s if net_s > 0 else 0.0
        return dataclasses.replace(
            base,
            name=base.name + name_suffix,
            ingest_bw=ingest if ingest > 0 else base.ingest_bw,
            net_bw=net if net > 0 else base.net_bw,
        )

    def embedding_odt(self, num_examples: int) -> tuple[float, float]:
        """Measured ``(odt_sync, odt_act)`` seconds per ``B_o`` window for
        an embedding layer, from observed traffic over ``num_examples``
        training examples — drop-in for ``LayerProfile`` fields."""
        if num_examples <= 0:
            return 0.0, 0.0
        t = self.totals()
        per_ex = (t["pull"]["seconds"] + t["push"]["seconds"]) / num_examples
        act_per_ex = t["pull"]["seconds"] / num_examples
        return per_ex * B_O, act_per_ex * B_O
