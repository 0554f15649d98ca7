"""Scheduling & provisioning plans (HeterPS §4.2, §5.1; the port's NumPy
copy of ``repro.core.plan``).

A *scheduling plan* assigns each layer to one resource type (the paper's
``Schedule(l, t)`` 0/1 matrix — we store the equivalent dense vector of
type indices).  Consecutive layers on the same type fuse into a *stage*;
a *provisioning plan* assigns each stage its replica count ``k_i``.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from repro_torch.core.profiles import LayerProfile
from repro_torch.core.resources import ResourceType


@dataclasses.dataclass(frozen=True)
class SchedulingPlan:
    """``assignment[l] = t`` — Layer ``l`` runs on resource Type ``t``."""

    assignment: tuple[int, ...]

    def __post_init__(self):
        object.__setattr__(self, "assignment", tuple(int(a) for a in self.assignment))

    @property
    def num_layers(self) -> int:
        return len(self.assignment)

    def stage_boundaries(self) -> list[tuple[int, int, int]]:
        """Fuse consecutive same-type layers: list of (start, end, type)."""
        out: list[tuple[int, int, int]] = []
        start = 0
        for i in range(1, len(self.assignment) + 1):
            if i == len(self.assignment) or self.assignment[i] != self.assignment[start]:
                out.append((start, i, self.assignment[start]))
                start = i
        return out


@dataclasses.dataclass(frozen=True)
class Stage:
    """One pipeline stage: fused consecutive layers on one resource type.

    ``oct``/``odt`` are the stage's aggregate original computation /
    communication times for a ``B_o`` batch on ONE unit of its type
    (paper §4.1): computation sums over the fused layers; communication is
    the boundary activation hand-off plus the per-layer parameter sync.
    """

    index: int
    layer_range: tuple[int, int]
    resource_type: int
    oct: float
    odt: float
    alpha: float
    beta: float


@dataclasses.dataclass(frozen=True)
class ProvisioningPlan:
    """``k[i]`` replicas for stage ``i`` (+ optional PS cores, §5.1)."""

    k: tuple[int, ...]
    ps_cores: int = 0


def build_stages(
    plan: SchedulingPlan,
    profiles: Sequence[LayerProfile],
    fleet: Sequence[ResourceType],
) -> list[Stage]:
    """Fuse layers into stages and aggregate OCT/ODT (paper §4.1)."""
    assert len(profiles) == plan.num_layers
    stages = []
    bounds = plan.stage_boundaries()
    for si, (s, e, t) in enumerate(bounds):
        layers = profiles[s:e]
        oct_ = sum(p.oct[t] for p in layers)
        # Communication = per-layer parameter/gradient sync for every fused
        # layer, plus the activation hand-off to the next stage for the
        # LAST layer only — interior activations stay on-device inside a
        # stage (this is why fusing consecutive layers "reduces the time
        # to transfer data", paper §1).
        odt_ = sum(p.odt_sync[t] for p in layers)
        odt_ += layers[-1].odt_act[t]
        # Amdahl fractions: OCT-weighted average over fused layers.
        w = max(oct_, 1e-30)
        alpha = sum(p.alpha * p.oct[t] for p in layers) / w
        beta = sum(p.beta * p.oct[t] for p in layers) / max(
            sum(p.oct[t] for p in layers), 1e-30
        )
        stages.append(
            Stage(
                index=si, layer_range=(s, e), resource_type=t,
                oct=oct_, odt=odt_, alpha=alpha, beta=beta,
            )
        )
    return stages


@dataclasses.dataclass(frozen=True)
class StageBatch:
    """Stage-level arrays for ``N`` plans at once (batched ``build_stages``).

    All per-stage arrays are ``(N, S)`` where ``S`` is the maximum stage
    count in the batch; slots at or past a plan's ``num_stages[n]`` are
    invalid (``mask`` False, zero oct/odt, type 0).  Per-plan reductions
    over the stage axis must exclude invalid slots.
    """

    rtype: np.ndarray       # (N, S) int — resource type per stage
    oct: np.ndarray         # (N, S) — aggregate OCT per stage
    odt: np.ndarray         # (N, S) — aggregate ODT per stage
    alpha: np.ndarray       # (N, S) — OCT-weighted Amdahl compute fraction
    beta: np.ndarray        # (N, S) — OCT-weighted Amdahl comm fraction
    mask: np.ndarray        # (N, S) bool — valid stage slots
    num_stages: np.ndarray  # (N,) int

    @property
    def batch(self) -> int:
        return self.oct.shape[0]

    @property
    def max_stages(self) -> int:
        return self.oct.shape[1]

    def take(self, idx: np.ndarray) -> "StageBatch":
        """Row subset (used to rescue only the infeasible plans)."""
        return StageBatch(
            rtype=self.rtype[idx], oct=self.oct[idx], odt=self.odt[idx],
            alpha=self.alpha[idx], beta=self.beta[idx], mask=self.mask[idx],
            num_stages=self.num_stages[idx],
        )


def batched_build_stages(
    assignments: np.ndarray,
    profiles: Sequence[LayerProfile],
    fleet: Sequence[ResourceType],
) -> StageBatch:
    """Vectorized :func:`build_stages` over an ``(N, L)`` assignment batch.

    Stage aggregation uses ``np.bincount`` segment sums, in flat-index
    (= layer) order like the scalar ``sum()``; per-stage aggregates agree
    with the scalar path to float64 rounding (relative differences of a
    few 1e-16 have been seen under NumPy 2, so compare at a tolerance).
    """
    A = np.asarray(assignments, dtype=np.int64)
    if A.ndim != 2:
        raise ValueError(f"assignments must be (N, L), got shape {A.shape}")
    N, L = A.shape
    if L != len(profiles):
        raise ValueError(f"{L} layers assigned, {len(profiles)} profiled")

    OCT = np.array([p.oct for p in profiles])        # (L, T)
    SYNC = np.array([p.odt_sync for p in profiles])  # (L, T)
    ACT = np.array([p.odt_act for p in profiles])    # (L, T)
    AL = np.array([p.alpha for p in profiles])       # (L,)
    BE = np.array([p.beta for p in profiles])        # (L,)

    lay = np.arange(L)
    oct_l = OCT[lay, A]                              # (N, L)
    sync_l = SYNC[lay, A]
    act_l = ACT[lay, A]

    change = np.ones((N, L), dtype=bool)
    change[:, 1:] = A[:, 1:] != A[:, :-1]
    sid = np.cumsum(change, axis=1) - 1              # (N, L) stage id per layer
    num_stages = sid[:, -1] + 1
    S = int(num_stages.max())
    flat = (np.arange(N)[:, None] * S + sid).ravel()

    def seg(v: np.ndarray) -> np.ndarray:
        return np.bincount(flat, weights=v.ravel(), minlength=N * S).reshape(N, S)

    oct_s = seg(oct_l)
    # activation hand-off counts only for the last layer of each stage
    is_last = np.ones((N, L), dtype=bool)
    is_last[:, :-1] = change[:, 1:]
    odt_s = seg(sync_l) + seg(np.where(is_last, act_l, 0.0))
    w = np.maximum(oct_s, 1e-30)
    alpha_s = seg(AL[None, :] * oct_l) / w
    beta_s = seg(BE[None, :] * oct_l) / w
    rtype = np.zeros((N, S), dtype=np.int64)
    rtype[np.arange(N)[:, None], sid] = A
    mask = np.arange(S)[None, :] < num_stages[:, None]
    return StageBatch(
        rtype=rtype, oct=oct_s, odt=odt_s, alpha=alpha_s, beta=beta_s,
        mask=mask, num_stages=num_stages,
    )


def type_counts(
    plan: SchedulingPlan, prov: ProvisioningPlan, num_types: int
) -> list[int]:
    """``k_t`` — total units of each type across stages (Formula 7)."""
    counts = [0] * num_types
    for (s, e, t), k in zip(plan.stage_boundaries(), prov.k):
        counts[t] += k
    # PS cores are CPU cores (type 0) in the paper's architecture.
    counts[0] += prov.ps_cores
    return counts
