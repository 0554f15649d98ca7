"""Tier-aware row placement — HeterPS §3's data-management loop, closed
(port of ``repro.ps.placement``).

The paper's monitor "counts the access frequency of each parameter …
and the data management module dynamically adjusts it to the high-speed
storage devices".  ``data/cache.py``'s :class:`AccessMonitor` is the
counting half; :class:`TierPlacer` is the acting half: every ``interval``
steps it recomputes the placement from the (EMA-aged) access counts and
re-pins rows:

* the decision lands in the table's per-shard ``tiers`` arrays
  (simulated storage tiers — pull telemetry then reports the DEVICE-tier
  hit fraction, so placement quality is observable), and
* the DEVICE-tier rows — hottest first — are loaded into the table's
  **hot-row cache** (:meth:`ShardedTable.install_hot_rows`), which lives
  on the table's device (the card) while the shard servers keep the
  slabs in host memory,
* the counts are aged *after* acting (EMA), so the hot set drifts with
  the access distribution instead of fossilizing the warm-up traffic.
"""

from __future__ import annotations

import numpy as np

from repro_torch.data.cache import Tier
from repro_torch.ps.sharding import ShardedTable


class TierPlacer:
    """Periodically re-pins a :class:`ShardedTable`'s rows from its
    :class:`~repro_torch.data.cache.AccessMonitor`'s placement decisions."""

    def __init__(self, table: ShardedTable, monitor, *, interval: int = 100,
                 age_on_repin: bool = True):
        if monitor.counts.shape[0] != table.vocab:
            raise ValueError(
                f"monitor covers {monitor.counts.shape[0]} rows, table has "
                f"{table.vocab}")
        self.table = table
        self.monitor = monitor
        self.interval = max(1, int(interval))
        self.age_on_repin = age_on_repin
        self.repins = 0
        self.last_stats: dict | None = None

    def step(self, step_idx: int) -> dict | None:
        """Call once per training step; re-pins every ``interval`` steps
        (and not at step 0, when no accesses have been counted yet).
        Returns the placement stats when a re-pin happened."""
        if step_idx == 0 or step_idx % self.interval:
            return None
        return self.repin()

    def repin(self) -> dict:
        # one snapshot for both the tier decision and the hottest-first
        # ordering — the puller thread keeps recording while we run
        counts = self.monitor.snapshot_counts()
        placement = self.monitor.placement(counts)
        stats = self.table.set_tiers(placement)
        # hottest DEVICE-tier rows first, so a capacity-truncated cache
        # keeps the head of the access distribution
        hot = np.flatnonzero(placement == Tier.DEVICE)
        hot = hot[np.argsort(-counts[hot], kind="stable")]
        stats["cached_rows"] = self.table.install_hot_rows(hot)
        if self.repins == 0:
            # after the first re-pin the hot cache covers the head of the
            # distribution — main storage is the host tier
            self.table.demote_storage()
        if self.age_on_repin:
            # age *after* acting so the decision reflects the full window,
            # and the next window starts discounted (EMA drift)
            self.monitor.age()
        self.repins += 1
        self.last_stats = stats
        return stats
