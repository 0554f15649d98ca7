"""Hot/cold parameter tiering — HeterPS data-management module (§3; copy
of ``repro.data.cache``, NumPy only).

The paper: "there is a monitor that counts the access frequency of each
parameter.  If the access frequency is high, the monitor marks the
parameters as hot parameters, and the data management module dynamically
adjusts it to the high-speed storage devices … otherwise it puts it to
SSDs or normal hard disks."

Here the tiers are device memory (the CTR path's hot-row cache on the
card) vs host memory (the shard servers' slabs) vs disk.  The monitor is
pure policy: it consumes access counts (row-level touch counts of an
embedding table) and emits placement decisions, which
``repro_torch.ps.placement.TierPlacer`` applies.  The counts age (EMA) so
the working set can drift with the data distribution.
"""

from __future__ import annotations

import dataclasses
import enum
import threading

import numpy as np


class Tier(enum.Enum):
    DEVICE = "device"       # HBM — hot
    HOST = "pinned_host"    # host RAM — warm
    DISK = "disk"           # SSD / checkpoint — cold


@dataclasses.dataclass
class TierThresholds:
    hot_fraction: float = 0.1    # top-x% of access mass → DEVICE
    warm_fraction: float = 0.5   # next slice → HOST
    ema: float = 0.9             # access-count decay per epoch


class AccessMonitor:
    """Counts row-level accesses of a (sharded) embedding table and
    assigns storage tiers by access mass.

    Thread-safe: the PS client records accesses from its puller thread
    while the tier placer reads/ages the counts on the main thread, and
    numpy releases the GIL on large-array ops — a lock keeps the counts
    coherent.
    """

    def __init__(self, num_rows: int, thresholds: TierThresholds | None = None):
        self.counts = np.zeros((num_rows,), np.float64)
        self.thresholds = thresholds or TierThresholds()
        self._lock = threading.Lock()

    def record(self, row_ids: np.ndarray) -> None:
        ids, cnt = np.unique(np.asarray(row_ids).ravel(), return_counts=True)
        if ids.size == 0:
            return
        # `ids` is sorted, so the extremes are the range check.  A silent
        # wrap/clip here would credit the wrong rows and skew placement.
        num_rows = self.counts.shape[0]
        if ids[0] < 0 or ids[-1] >= num_rows:
            raise ValueError(
                f"row ids out of range: got ids in [{ids[0]}, {ids[-1]}] for "
                f"a table with {num_rows} rows (expected 0 <= id < {num_rows})"
            )
        with self._lock:
            self.counts[ids] += cnt

    def age(self) -> None:
        with self._lock:
            self.counts *= self.thresholds.ema

    def snapshot_counts(self) -> np.ndarray:
        """Locked copy of the access counts — hand it to :meth:`placement`
        so a decision and any count-ordered post-processing (e.g. the tier
        placer's hottest-first cache fill) see the same state."""
        with self._lock:
            return self.counts.copy()

    def placement(self, counts: np.ndarray | None = None) -> np.ndarray:
        """Tier per row (np array of Tier) — hot rows by cumulative access
        mass, ties broken toward DEVICE.  ``counts`` defaults to a fresh
        :meth:`snapshot_counts`."""
        t = self.thresholds
        if self.counts.size == 0:
            return np.empty((0,), dtype=object)
        if counts is None:
            counts = self.snapshot_counts()
        order = np.argsort(-counts, kind="stable")
        mass = np.cumsum(counts[order])
        total = mass[-1] if mass[-1] > 0 else 1.0
        # classify by cumulative mass *before* the row: a row starts hot if
        # the hot budget isn't already filled when we reach it (so the
        # single hottest row is always DEVICE).
        frac_before = (mass - counts[order]) / total
        tiers = np.full(counts.shape, Tier.DISK, dtype=object)
        accessed = counts[order] > 0
        hot = order[(frac_before < t.hot_fraction) & accessed]
        warm = order[(frac_before >= t.hot_fraction)
                     & (frac_before < t.warm_fraction) & accessed]
        tiers[hot] = Tier.DEVICE
        tiers[warm] = Tier.HOST
        return tiers

    def stats(self) -> dict:
        p = self.placement()
        return {
            "device_rows": int((p == Tier.DEVICE).sum()),
            "host_rows": int((p == Tier.HOST).sum()),
            "disk_rows": int((p == Tier.DISK).sum()),
            "total_accesses": float(self.counts.sum()),
        }
