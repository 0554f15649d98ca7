"""HeterPS cost model — Formulas 1–7 (§4.1; the port's NumPy copy of
``repro.core.cost_model``, the oracle the device cost model is held to).

Estimates per-stage computation/communication time, pipeline throughput,
end-to-end execution time, and monetary cost for a (scheduling plan,
provisioning plan) pair.

Note on Formula 1/2 scaling: the paper writes ``CT_i = OCT_i/B_o *
(1-α+α/k)`` and then ``Throughput_i = B/ET_i``.  Dimensional consistency
requires CT to be the time of a *full batch* ``B``, i.e. ``CT_i =
(OCT_i/B_o)·B·(1-α+α/k)`` — ``OCT_i/B_o`` is the profiled per-example
time.  We implement that reading (an erratum of the paper's text).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np

from repro_torch.core.plan import (
    ProvisioningPlan,
    SchedulingPlan,
    Stage,
    StageBatch,
    batched_build_stages,
    build_stages,
    type_counts,
)
from repro_torch.core.profiles import B_O, LayerProfile
from repro_torch.core.resources import ResourceType

#: cost returned for infeasible plans (constraint violations, Formula 10)
INFEASIBLE = float("inf")


@dataclasses.dataclass(frozen=True)
class TrainingJob:
    """The workload the plans are evaluated against.

    Attributes:
      batch_size: global batch size ``B``.
      num_examples: ``M`` examples per epoch.
      num_epochs: ``L`` epochs.
      throughput_limit: minimum examples/s (Formula 10).
    """

    batch_size: int = 4096
    num_examples: int = 4_000_000_000   # ads-scale feature logs (~10 TB, §1)
    num_epochs: int = 1
    throughput_limit: float = 200_000.0  # examples/s


def stage_compute_time(stage: Stage, k: int, batch_size: int) -> float:
    """Formula 1 (batch-scaled): ``CT_i``."""
    k = max(1, int(k))
    return (stage.oct / B_O) * batch_size * (1.0 - stage.alpha + stage.alpha / k)


def stage_comm_time(stage: Stage, k: int, batch_size: int) -> float:
    """Formula 2 (batch-scaled): ``DT_i``."""
    k = max(1, int(k))
    return (stage.odt / B_O) * batch_size * (1.0 - stage.beta + stage.beta / k)


def stage_exec_time(stage: Stage, k: int, batch_size: int) -> float:
    """Formula 3: computation/communication overlap → max of the two."""
    return max(
        stage_compute_time(stage, k, batch_size),
        stage_comm_time(stage, k, batch_size),
    )


def stage_throughput(stage: Stage, k: int, batch_size: int) -> float:
    """Formula 4: examples/s of stage ``i``."""
    return batch_size / stage_exec_time(stage, k, batch_size)


def pipeline_throughput(
    stages: Sequence[Stage], prov: ProvisioningPlan, batch_size: int
) -> float:
    """Formula 5: the pipeline is limited by its slowest stage."""
    return min(stage_throughput(s, k, batch_size) for s, k in zip(stages, prov.k))


def execution_time(
    stages: Sequence[Stage], prov: ProvisioningPlan, job: TrainingJob
) -> float:
    """Formula 6: ``ET = L · M / Throughput``."""
    tp = pipeline_throughput(stages, prov, job.batch_size)
    return job.num_epochs * job.num_examples / tp


def monetary_cost(
    plan: SchedulingPlan,
    prov: ProvisioningPlan,
    profiles: Sequence[LayerProfile],
    fleet: Sequence[ResourceType],
    job: TrainingJob,
    *,
    check_limits: bool = True,
    stages: Sequence[Stage] | None = None,
) -> float:
    """Formula 7 with the Formula-10 constraints.

    Returns :data:`INFEASIBLE` when the throughput constraint or a
    per-type resource limit is violated.  ``stages`` lets callers share
    already-built stages.
    """
    if stages is None:
        stages = build_stages(plan, profiles, fleet)
    if len(prov.k) != len(stages):
        raise ValueError(f"{len(prov.k)} k's for {len(stages)} stages")
    counts = type_counts(plan, prov, len(fleet))
    if check_limits:
        for t, (n, res) in enumerate(zip(counts, fleet)):
            if n > res.max_count:
                return INFEASIBLE
        if pipeline_throughput(stages, prov, job.batch_size) < job.throughput_limit:
            return INFEASIBLE
    et = execution_time(stages, prov, job)
    rate = sum(n * res.price_per_sec for n, res in zip(counts, fleet))
    return et * rate


def plan_cost(
    plan: SchedulingPlan,
    profiles: Sequence[LayerProfile],
    fleet: Sequence[ResourceType],
    job: TrainingJob,
    *,
    stages: Sequence[Stage] | None = None,
) -> tuple[float, ProvisioningPlan | None]:
    """Cost of a scheduling plan = cost under its best provisioning (§5).

    This is the reward the RL scheduler optimizes (Algorithm 1, Line 5):
    the provisioning module is invoked inside the cost evaluation.
    ``stages`` lets callers that already built the plan's stages share
    them instead of re-deriving.
    """
    from repro_torch.core.provision import provision  # cycle-free late import

    if stages is None:
        stages = build_stages(plan, profiles, fleet)
    prov = provision(stages, fleet, job)
    if prov is None:
        return INFEASIBLE, None
    return (
        monetary_cost(plan, prov, profiles, fleet, job, stages=stages),
        prov,
    )


def soft_plan_cost(
    plan: SchedulingPlan,
    profiles: Sequence[LayerProfile],
    fleet: Sequence[ResourceType],
    job: TrainingJob,
    *,
    stages: Sequence[Stage] | None = None,
    cost: float | None = None,
) -> float:
    """Graded surrogate for search rewards (beyond-paper refinement).

    A flat penalty for infeasible plans gives REINFORCE/GA/BO zero
    gradient when *every* sampled plan violates the constraint (common
    early in training for deep models where one bad stage placement hits
    the Amdahl ceiling).  Instead, re-evaluate the plan at its *achievable*
    throughput and scale the cost by the squared constraint-violation
    ratio — infeasible plans are ordered by how infeasible they are.
    Feasible plans return their true cost.

    ``stages``/``cost`` let callers that already evaluated the plan (e.g.
    ``CostCache``) share that work instead of re-running ``build_stages``
    and the full provisioning search.
    """
    import dataclasses as _dc

    from repro_torch.core.provision import provision

    if stages is None:
        stages = build_stages(plan, profiles, fleet)
    if cost is None:
        cost, _ = plan_cost(plan, profiles, fleet, job, stages=stages)
    if math.isfinite(cost):
        return cost
    tp_max = min(
        stage_throughput(s, fleet[s.resource_type].max_count, job.batch_size)
        for s in stages
    )
    if tp_max <= 0:
        return 1e15
    relaxed = _dc.replace(job, throughput_limit=min(tp_max * 0.5,
                                                    job.throughput_limit))
    prov = provision(stages, fleet, relaxed)
    if prov is None:
        return 1e15
    base = monetary_cost(plan, prov, profiles, fleet, relaxed,
                         check_limits=False, stages=stages)
    violation = max(job.throughput_limit / max(tp_max, 1e-9), 1.0)
    return base * 10.0 * violation**2


# --- batched evaluation (Formulas 1–7 over N plans at once) ------------------
#
# The scalar functions above remain the reference oracle; the batched path
# below evaluates an (N, L) assignment batch with NumPy array ops and a
# vectorized provisioning search (see provision.batched_provision).  Each
# plan's arithmetic follows the same operation sequence as the scalar path,
# so results agree with it to float64 rounding.


#: plans per vectorized slice — around this size the working set of (N, S)
#: temporaries stays cache-resident; larger batches are internally chunked
#: (throughput falls off a cliff once the Newton loop spills to DRAM)
EVAL_CHUNK = 512


@dataclasses.dataclass(frozen=True)
class BatchedCost:
    """Result of :func:`batched_plan_cost` for N plans.

    ``costs[i]`` is the true monetary cost (:data:`INFEASIBLE` when no
    feasible provisioning exists); ``prov(i)`` materializes plan ``i``'s
    chosen provisioning as a scalar :class:`ProvisioningPlan`.
    """

    costs: np.ndarray       # (N,)
    k: np.ndarray           # (N, S) int replica counts (0 past num_stages)
    ps_cores: np.ndarray    # (N,) int
    num_stages: np.ndarray  # (N,) int
    feasible: np.ndarray    # (N,) bool

    def prov(self, i: int) -> ProvisioningPlan | None:
        if not self.feasible[i]:
            return None
        n = int(self.num_stages[i])
        return ProvisioningPlan(
            k=tuple(int(x) for x in self.k[i, :n]),
            ps_cores=int(self.ps_cores[i]),
        )


def _concat_batched(parts: list[BatchedCost]) -> BatchedCost:
    """Stack chunked results; pad ``k`` to the widest stage count."""
    S = max(p.k.shape[1] for p in parts)
    ks = []
    for p in parts:
        pad = S - p.k.shape[1]
        ks.append(np.pad(p.k, ((0, 0), (0, pad))) if pad else p.k)
    return BatchedCost(
        costs=np.concatenate([p.costs for p in parts]),
        k=np.concatenate(ks),
        ps_cores=np.concatenate([p.ps_cores for p in parts]),
        num_stages=np.concatenate([p.num_stages for p in parts]),
        feasible=np.concatenate([p.feasible for p in parts]),
    )


def _batched_monetary_cost(
    sb: StageBatch,
    k: np.ndarray,
    ps: np.ndarray,
    fleet: Sequence[ResourceType],
    job: TrainingJob,
) -> np.ndarray:
    """Formulas 5–7 for integer provisioning, no constraint checks."""
    from repro_torch.core.provision import (
        _batched_int_throughput,
        _batched_type_counts,
    )

    tp = _batched_int_throughput(sb, k, job.batch_size)
    et = float(job.num_epochs * job.num_examples) / tp
    counts = _batched_type_counts(sb, k, ps, len(fleet))
    # left fold in fleet order == the scalar sum() over types
    rate = np.zeros(sb.batch)
    for t, res in enumerate(fleet):
        rate = rate + counts[:, t] * res.price_per_sec
    return et * rate


def batched_plan_cost(
    assignments: np.ndarray,
    profiles: Sequence[LayerProfile],
    fleet: Sequence[ResourceType],
    job: TrainingJob,
) -> BatchedCost:
    """Vectorized :func:`plan_cost` over an ``(N, L)`` assignment batch."""
    from repro_torch.core.provision import batched_provision

    assignments = np.asarray(assignments, dtype=np.int64)
    if len(assignments) > EVAL_CHUNK:
        return _concat_batched([
            batched_plan_cost(assignments[i:i + EVAL_CHUNK], profiles, fleet, job)
            for i in range(0, len(assignments), EVAL_CHUNK)
        ])
    sb = batched_build_stages(assignments, profiles, fleet)
    bp = batched_provision(sb, fleet, job)
    cost = np.where(
        bp.feasible,
        _batched_monetary_cost(sb, bp.k, bp.ps_cores, fleet, job),
        INFEASIBLE,
    )
    return BatchedCost(
        costs=cost, k=bp.k, ps_cores=bp.ps_cores,
        num_stages=sb.num_stages, feasible=bp.feasible,
    )


def batched_soft_plan_cost(
    assignments: np.ndarray,
    profiles: Sequence[LayerProfile],
    fleet: Sequence[ResourceType],
    job: TrainingJob,
) -> tuple[BatchedCost, np.ndarray]:
    """Vectorized (:func:`plan_cost`, :func:`soft_plan_cost`) in one pass.

    Returns the true-cost batch plus the graded surrogate vector; the
    stage arrays and true-cost provisioning are computed once and shared
    (the batched analogue of the ``CostCache.soft`` single-evaluation
    path).  Only the infeasible subset pays for the relaxed re-provision.
    """
    from repro_torch.core.provision import _batched_int_throughput, batched_provision

    assignments = np.asarray(assignments, dtype=np.int64)
    if len(assignments) > EVAL_CHUNK:
        parts = [
            batched_soft_plan_cost(assignments[i:i + EVAL_CHUNK], profiles, fleet, job)
            for i in range(0, len(assignments), EVAL_CHUNK)
        ]
        return (
            _concat_batched([bc for bc, _ in parts]),
            np.concatenate([s for _, s in parts]),
        )
    sb = batched_build_stages(assignments, profiles, fleet)
    bp = batched_provision(sb, fleet, job)
    cost = np.where(
        bp.feasible,
        _batched_monetary_cost(sb, bp.k, bp.ps_cores, fleet, job),
        INFEASIBLE,
    )
    soft = cost.copy()
    bad = ~np.isfinite(cost)
    if bad.any():
        idx = np.flatnonzero(bad)
        sub = sb.take(idx)
        # max achievable pipeline throughput: every stage at its type's limit
        max_counts = np.array([r.max_count for r in fleet])
        tp_max = _batched_int_throughput(
            sub, np.where(sub.mask, max_counts[sub.rtype], 0), job.batch_size
        )
        relaxed = np.minimum(tp_max * 0.5, float(job.throughput_limit))
        bp_r = batched_provision(sub, fleet, job, tau_min=relaxed)
        base = _batched_monetary_cost(sub, bp_r.k, bp_r.ps_cores, fleet, job)
        violation = np.maximum(
            float(job.throughput_limit) / np.maximum(tp_max, 1e-9), 1.0
        )
        graded = base * 10.0 * violation**2
        soft[idx] = np.where(bp_r.feasible & (tp_max > 0), graded, 1e15)
    return (
        BatchedCost(
            costs=cost, k=bp.k, ps_cores=bp.ps_cores,
            num_stages=sb.num_stages, feasible=bp.feasible,
        ),
        soft,
    )
