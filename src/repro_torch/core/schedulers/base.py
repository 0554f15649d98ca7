"""Scheduler interface + shared evaluation (HeterPS §5.2, §6.2; the
port's NumPy copy of ``repro.core.schedulers.base``)."""

from __future__ import annotations

import abc
import dataclasses
import math
import time
from typing import Sequence

import numpy as np

from repro_torch.core.cost_model import (
    INFEASIBLE,
    TrainingJob,
    batched_plan_cost,
    batched_soft_plan_cost,
    plan_cost,
)
from repro_torch.core.plan import ProvisioningPlan, SchedulingPlan
from repro_torch.core.profiles import LayerProfile
from repro_torch.core.resources import ResourceType


@dataclasses.dataclass
class ScheduleResult:
    plan: SchedulingPlan
    prov: ProvisioningPlan | None
    cost: float
    wall_time_s: float
    evaluations: int
    extra: dict = dataclasses.field(default_factory=dict)

    @property
    def feasible(self) -> bool:
        return math.isfinite(self.cost)


class Scheduler(abc.ABC):
    """Maps (layer profiles, fleet, job) → a scheduling plan."""

    name: str = "base"

    @abc.abstractmethod
    def _search(
        self,
        profiles: Sequence[LayerProfile],
        fleet: Sequence[ResourceType],
        job: TrainingJob,
    ) -> tuple[SchedulingPlan, int, dict]:
        """Return (best plan, #cost evaluations, extra info)."""

    def schedule(
        self,
        profiles: Sequence[LayerProfile],
        fleet: Sequence[ResourceType],
        job: TrainingJob,
    ) -> ScheduleResult:
        t0 = time.perf_counter()
        plan, evals, extra = self._search(profiles, fleet, job)
        wall = time.perf_counter() - t0
        cost, prov = plan_cost(plan, profiles, fleet, job)
        return ScheduleResult(
            plan=plan, prov=prov, cost=cost, wall_time_s=wall,
            evaluations=evals, extra=extra,
        )


class CostCache:
    """Memoizes ``plan_cost`` across a search (plans repeat a lot in GA/RL).

    ``soft()``/``batch_soft()`` return the graded surrogate (finite for
    infeasible plans, ordered by violation) used as search reward;
    ``__call__``/``batch_call()`` return the true cost (``inf`` when
    infeasible) used for final plan selection.  Scoring goes through the
    batched cost model (``batched_plan_cost``/``batched_soft_plan_cost``):
    each batch is deduplicated, novel plans are evaluated in one
    vectorized pass, and the true cost + surrogate come out of a single
    shared evaluation (no double provisioning for infeasible plans).
    """

    def __init__(self, profiles, fleet, job):
        self.profiles, self.fleet, self.job = profiles, fleet, job
        self._cache: dict[tuple[int, ...], float] = {}
        self._soft: dict[tuple[int, ...], float] = {}
        self.evaluations = 0
        #: True once seed_from_device wrote device-scored entries — they
        #: match the NumPy oracle only to float tolerance, so final-plan
        #: selection re-verifies the winner when this is set
        self.device_seeded = False

    @staticmethod
    def _keys(assignments) -> list[tuple[int, ...]]:
        return [tuple(int(a) for a in row) for row in assignments]

    def batch_call(self, assignments) -> np.ndarray:
        """True costs for a batch of assignment vectors (dedup + memo)."""
        keys = self._keys(assignments)
        novel = [k for k in dict.fromkeys(keys) if k not in self._cache]
        if novel:
            bc = batched_plan_cost(
                np.asarray(novel, dtype=np.int64),
                self.profiles, self.fleet, self.job,
            )
            self.evaluations += len(novel)
            for k, c in zip(novel, bc.costs):
                self._cache[k] = float(c)
        return np.array([self._cache[k] for k in keys])

    def batch_soft(self, assignments) -> np.ndarray:
        """Graded surrogate costs for a batch (dedup + memo, single pass)."""
        keys = self._keys(assignments)
        need: list[tuple[int, ...]] = []
        for k in dict.fromkeys(keys):
            if k in self._soft:
                continue
            cached = self._cache.get(k)
            if cached is not None and math.isfinite(cached):
                self._soft[k] = cached  # feasible → surrogate == true cost
            else:
                need.append(k)
        if need:
            bc, soft = batched_soft_plan_cost(
                np.asarray(need, dtype=np.int64),
                self.profiles, self.fleet, self.job,
            )
            for k, c, s in zip(need, bc.costs, soft):
                if k not in self._cache:
                    self.evaluations += 1
                    self._cache[k] = float(c)
                self._soft[k] = float(s)
        return np.array([self._soft[k] for k in keys])

    def seed_from_device(
        self, assignments, soft_costs, feasible=None
    ) -> int:
        """Bulk-insert already-computed surrogate costs (fused RL search).

        The fused search scores whole chunks of rounds on device
        (``torch_cost.soft_cost``) and back-fills the memo table once per
        chunk — this is that entry point.  ``soft_costs[i]`` is the graded
        surrogate for ``assignments[i]``; ``feasible[i]``, when given,
        lets the true-cost cache be filled too (feasible ⇒ true == soft,
        infeasible ⇒ true == inf), so ``best()`` sees device-scored plans.

        ``evaluations`` accounting stays exact: each *novel* plan counts
        once, plans already scored (by either path) count zero, and
        existing entries are never overwritten — a plan first evaluated by
        the NumPy oracle keeps its oracle-exact value.  Returns the number
        of novel plans inserted.
        """
        soft = np.asarray(soft_costs, dtype=np.float64)
        novel = 0
        for key, s, f in zip(
            self._keys(assignments),
            soft,
            np.asarray(feasible) if feasible is not None else soft,
        ):
            if key in self._soft:
                continue
            cached = self._cache.get(key)
            if cached is not None:
                # true cost known exactly (e.g. anchors): reuse it for the
                # surrogate when feasible, keep the device value otherwise
                self._soft[key] = cached if math.isfinite(cached) else float(s)
                continue
            novel += 1
            self.evaluations += 1
            self._soft[key] = float(s)
            if feasible is not None:
                self._cache[key] = float(s) if f else INFEASIBLE
                self.device_seeded = True
        return novel

    def __call__(self, assignment: Sequence[int]) -> float:
        key = tuple(int(a) for a in assignment)
        if key not in self._cache:
            self.batch_call([key])
        return self._cache[key]

    def soft(self, assignment: Sequence[int]) -> float:
        key = tuple(int(a) for a in assignment)
        if key not in self._soft:
            self.batch_soft([key])
        return self._soft[key]

    def pin_true(self, assignment: Sequence[int], cost: float) -> None:
        """Overwrite a memo entry with an oracle-computed true cost.

        Unlike :meth:`seed_from_device`, this *does* overwrite: it exists
        for the final-selection path to correct a device-scored entry
        whose feasibility the NumPy oracle disagrees with (possible only
        on exact constraint boundaries, where f64 op-reordering flips a
        comparison).  Does not touch ``evaluations``.
        """
        key = tuple(int(a) for a in assignment)
        self._cache[key] = float(cost)
        if math.isfinite(cost):
            self._soft[key] = float(cost)

    def best(self) -> tuple[tuple[int, ...], float]:
        feas = {k: v for k, v in self._cache.items() if math.isfinite(v)}
        if not feas:
            k = min(self._cache, key=self._cache.get)
            return k, self._cache[k]
        k = min(feas, key=feas.get)
        return k, feas[k]


def penalized(cost: float, penalty: float) -> float:
    """Finite stand-in for infeasible plans (RL/GA need finite rewards)."""
    return penalty if cost == INFEASIBLE or not math.isfinite(cost) else cost
