"""Static / heuristic baselines (HeterPS §6.2): CPU, GPU, Heuristic, BF,
Greedy (the port's NumPy copy of ``repro.core.schedulers.static``)."""

from __future__ import annotations

import itertools
import math
from typing import Sequence

import numpy as np

from repro_torch.core.cost_model import TrainingJob
from repro_torch.core.plan import SchedulingPlan
from repro_torch.core.profiles import LayerProfile
from repro_torch.core.resources import ResourceType
from repro_torch.core.schedulers.base import CostCache, Scheduler


class CPUOnlyScheduler(Scheduler):
    """All layers on CPU (type 0)."""

    name = "CPU"

    def _search(self, profiles, fleet, job):
        return SchedulingPlan((0,) * len(profiles)), 1, {}


class GPUOnlyScheduler(Scheduler):
    """All layers on one accelerator type (the cheapest feasible one)."""

    name = "GPU"

    def _search(self, profiles, fleet, job):
        cache = CostCache(profiles, fleet, job)
        plans = [(t,) * len(profiles) for t in range(1, len(fleet))]
        costs = cache.batch_call(plans)
        best_t = 1
        if np.isfinite(costs).any():
            best_t = 1 + int(np.argmin(costs))
        return SchedulingPlan((best_t,) * len(profiles)), cache.evaluations, {}


class HeuristicScheduler(Scheduler):
    """AIBox/BytePS-style static rule (§1, [61]): the first (embedding,
    data-intensive) layer goes to CPUs, every other layer to GPUs."""

    name = "Heuristic"

    def _search(self, profiles, fleet, job):
        assignment = [0 if p.kind in ("embedding",) or p.index == 0 else 1
                      for p in profiles]
        return SchedulingPlan(tuple(assignment)), 1, {}


class BruteForceScheduler(Scheduler):
    """Exhaustive enumeration of all ``T^L`` plans — optimal but exponential
    (paper Table 2).  ``max_evals`` aborts overlong searches; the search is
    exact whenever ``T**L <= max_evals``."""

    name = "BF"

    def __init__(self, max_evals: int = 2_000_000, chunk: int = 4096):
        self.max_evals = max_evals
        self.chunk = chunk

    def _search(self, profiles, fleet, job):
        T, L = len(fleet), len(profiles)
        cache = CostCache(profiles, fleet, job)
        n = 0
        batch: list[tuple[int, ...]] = []
        for assignment in itertools.product(range(T), repeat=L):
            batch.append(assignment)
            n += 1
            if len(batch) >= self.chunk:
                cache.batch_call(batch)
                batch.clear()
            if n >= self.max_evals:
                break
        if batch:
            cache.batch_call(batch)
        best, _ = cache.best()
        return SchedulingPlan(best), cache.evaluations, {"exhaustive": T**L <= self.max_evals}


class GreedyScheduler(Scheduler):
    """Sequential greedy (§2.2 [51]): scan layers in order; for each layer
    pick the type minimizing the cost of the partial plan (suffix filled
    with the per-layer locally-cheapest type).  Falls into local optima —
    the paper's criticism."""

    name = "Greedy"

    def _search(self, profiles, fleet, job):
        T, L = len(fleet), len(profiles)
        cache = CostCache(profiles, fleet, job)

        # local (single-layer standalone) preference used to fill the suffix
        def local_best(p: LayerProfile) -> int:
            # cheapest type by single-unit cost rate for this layer alone
            return min(
                range(T),
                key=lambda t: (p.oct[t] + p.odt[t]) * fleet[t].price_per_sec
                * max(1.0, 1.0),
            )

        suffix = [local_best(p) for p in profiles]
        chosen: list[int] = []
        for l in range(L):
            cands = [tuple(chosen) + (t,) + tuple(suffix[l + 1:])
                     for t in range(T)]
            costs = cache.batch_call(cands)  # all T candidates in one pass
            if np.isfinite(costs).any():
                best_t = int(np.argmin(costs))
            else:
                best_t = suffix[l]
            chosen.append(best_t)
        plan = tuple(chosen)
        if not math.isfinite(cache(plan)):
            best, _ = cache.best()
            plan = best
        return SchedulingPlan(plan), cache.evaluations, {}
