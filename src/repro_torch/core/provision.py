"""Provisioning for load balance (HeterPS §5.1, Formulas 11–13; the
port's NumPy copy of ``repro.core.provision``).

Given a scheduling plan's stages, choose replica counts ``k_i`` so that
(a) every stage sustains the same throughput (no pipeline straggler),
(b) the throughput constraint holds (Formula 13 lower-bounds ``k_1``),
(c) monetary cost is minimized — a Newton iteration on the continuous
relaxation of ``k_1`` (the paper uses Newton's method on ``k_1``), then
integer rounding with a local feasibility search.

Also provides the two static baselines of §6.1: ``StaRatio`` (GPU:CPU
cores 1:6, AIBox default) and ``StaPSRatio`` (1:6 + 6 PS cores per GPU,
BytePS-style).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np

from repro_torch.core.cost_model import (
    TrainingJob,
    stage_throughput,
)
from repro_torch.core.plan import ProvisioningPlan, Stage, StageBatch
from repro_torch.core.profiles import B_O
from repro_torch.core.resources import ResourceType


def required_k(stage: Stage, throughput: float, batch_size: int) -> float:
    """Smallest continuous ``k`` giving ``stage`` at least ``throughput``.

    Inverts Formulas 1–4: both the compute and the comm term must fit in
    ``B/throughput`` seconds.  Returns ``inf`` when the sequential
    (non-parallelizable) fraction alone exceeds the budget — no number of
    replicas can reach that throughput (Amdahl ceiling).
    """
    budget = 1.0 / throughput  # seconds per example
    ks = []
    for time_per_ex, frac in ((stage.oct / B_O, stage.alpha), (stage.odt / B_O, stage.beta)):
        if time_per_ex <= 0.0:
            ks.append(0.0)
            continue
        slack = budget / time_per_ex - (1.0 - frac)
        if slack <= 0.0:
            return float("inf")
        ks.append(frac / slack)
    return max(max(ks), 1.0)


def _balanced_k(
    stages: Sequence[Stage], throughput: float, batch_size: int
) -> list[float] | None:
    """Formula 12 generalized: per-stage continuous ``k_i`` at equal throughput."""
    ks = []
    for s in stages:
        k = required_k(s, throughput, batch_size)
        if not math.isfinite(k):
            return None
        ks.append(k)
    return ks


def _ps_cores(stages: Sequence[Stage], k: Sequence[float]) -> int:
    """CPU cores added for parameter servers (§5.1: "based on historical
    profiling results") — the paper's default server ratio is ~1 PS core
    per 6 accelerator units."""
    n_accel = sum(kk for s, kk in zip(stages, k) if s.resource_type != 0)
    return int(math.ceil(n_accel / 6.0)) if n_accel > 0 else 0


def _cost_at_throughput(
    stages: Sequence[Stage],
    fleet: Sequence[ResourceType],
    job: TrainingJob,
    throughput: float,
) -> tuple[float, list[float] | None]:
    """Continuous-relaxation cost at a target throughput (load-balanced)."""
    ks = _balanced_k(stages, throughput, job.batch_size)
    if ks is None:
        return float("inf"), None
    rate = sum(
        k * fleet[s.resource_type].price_per_sec for s, k in zip(stages, ks)
    )
    rate += _ps_cores(stages, ks) * fleet[0].price_per_sec
    et = job.num_epochs * job.num_examples / throughput
    return et * rate, ks


def provision(
    stages: Sequence[Stage],
    fleet: Sequence[ResourceType],
    job: TrainingJob,
    *,
    newton_iters: int = 25,
) -> ProvisioningPlan | None:
    """Generate a provisioning plan for ``stages`` (§5.1).

    Newton's method on the continuous throughput target ``τ`` (equivalent
    to the paper's iteration on ``k_1`` — ``τ`` and ``k_1`` are related
    1:1 by Formula 12/13; optimizing τ directly avoids singling out
    stage 1): minimize ``cost(τ)`` for ``τ ≥ throughput_limit``, then
    round to integers and locally repair feasibility.

    Returns ``None`` when no feasible provisioning exists (resource
    limits, Formula 10).
    """
    tau_min = job.throughput_limit
    c0, ks0 = _cost_at_throughput(stages, fleet, job, tau_min)
    if ks0 is None:
        return None

    # Newton on f(τ) = d cost/d τ, seeking interior minima; cost(τ) is
    # usually increasing past the constraint (paper §5.1 observes this),
    # in which case Newton stays pinned at τ_min.
    tau, best_tau, best_cost = tau_min, tau_min, c0
    h = max(tau_min * 1e-4, 1e-9)
    for _ in range(newton_iters):
        cm, _ = _cost_at_throughput(stages, fleet, job, max(tau - h, tau_min))
        cp, _ = _cost_at_throughput(stages, fleet, job, tau + h)
        cc, _ = _cost_at_throughput(stages, fleet, job, tau)
        if not (math.isfinite(cm) and math.isfinite(cp) and math.isfinite(cc)):
            break
        g = (cp - cm) / (2 * h)
        hess = (cp - 2 * cc + cm) / (h * h)
        if hess <= 0.0 or not math.isfinite(hess):
            step = -math.copysign(0.1 * tau, g)
        else:
            step = -g / hess
        new_tau = max(tau_min, tau + step)
        c_new, _ = _cost_at_throughput(stages, fleet, job, new_tau)
        if math.isfinite(c_new) and c_new < best_cost:
            best_cost, best_tau = c_new, new_tau
        if abs(new_tau - tau) < 1e-6 * tau_min:
            tau = new_tau
            break
        tau = new_tau

    _, ks = _cost_at_throughput(stages, fleet, job, best_tau)
    if ks is None:
        return None
    k_int = [int(math.ceil(k)) for k in ks]

    # Feasibility: per-type limits (Formula 10).
    counts: dict[int, int] = {}
    for s, k in zip(stages, k_int):
        counts[s.resource_type] = counts.get(s.resource_type, 0) + k
    ps = _ps_cores(stages, k_int)
    counts[0] = counts.get(0, 0) + ps
    for t, n in counts.items():
        if n > fleet[t].max_count:
            return None
    # Throughput check with the integer k (ceil only raises throughput,
    # so this should hold; guard against degenerate stages anyway).
    tp = min(
        stage_throughput(s, k, job.batch_size) for s, k in zip(stages, k_int)
    )
    if tp < job.throughput_limit:
        return None
    return ProvisioningPlan(k=tuple(k_int), ps_cores=ps)


# --- batched provisioning (vectorized over N plans) --------------------------
#
# The scalar `provision` above is the reference oracle; the functions below
# run the same algorithm — continuous balanced-k inversion of Formulas 1–4,
# Newton iteration on the throughput target τ, integer rounding, limit and
# throughput checks — for N plans at once with NumPy.  Per-plan reductions
# over the stage axis are written as explicit left folds so each plan's
# arithmetic is the same operation sequence as the scalar path.


@dataclasses.dataclass(frozen=True)
class BatchedProvisioning:
    """Integer provisioning for a :class:`StageBatch` (invalid slots k=0)."""

    k: np.ndarray         # (N, S) int replica counts
    ps_cores: np.ndarray  # (N,) int
    feasible: np.ndarray  # (N,) bool — limits + throughput constraint hold


@dataclasses.dataclass(frozen=True)
class _ProvisionCtx:
    """Loop-invariant arrays for one batched provisioning run."""

    tc: np.ndarray           # (N, S) per-example compute time  (oct / B_o)
    tm: np.ndarray           # (N, S) per-example comm time     (odt / B_o)
    alpha: np.ndarray        # (N, S)
    beta: np.ndarray         # (N, S)
    na: np.ndarray           # (N, S) 1 - alpha
    nb: np.ndarray           # (N, S) 1 - beta
    mask: np.ndarray         # (N, S)
    stage_price: np.ndarray  # (N, S) price/s per stage (0 in invalid slots)
    accel: np.ndarray        # (N, S) 1.0 where the stage is on an accelerator
    cpu_price: float
    et_num: float            # num_epochs * num_examples


def _provision_ctx(
    sb: StageBatch, fleet: Sequence[ResourceType], job: TrainingJob
) -> _ProvisionCtx:
    price = np.array([r.price_per_sec for r in fleet])
    return _ProvisionCtx(
        tc=sb.oct / B_O, tm=sb.odt / B_O,
        alpha=sb.alpha, beta=sb.beta,
        na=1.0 - sb.alpha, nb=1.0 - sb.beta,
        mask=sb.mask,
        stage_price=np.where(sb.mask, price[sb.rtype], 0.0),
        accel=np.where(sb.mask & (sb.rtype != 0), 1.0, 0.0),
        cpu_price=float(price[0]),
        et_num=float(job.num_epochs * job.num_examples),
    )


def _batched_required_k(ctx: _ProvisionCtx, throughput: np.ndarray) -> np.ndarray:
    """Vectorized :func:`required_k`: (N, S) continuous k at per-plan τ.

    Invalid stage slots (zero oct/odt) come out as the clamp value 1.0;
    callers must mask them out.  A valid slot past its Amdahl ceiling is
    ``inf`` — no replica count reaches the target throughput.
    """
    budget = 1.0 / throughput[:, None]                   # (N, 1) s/example
    out = np.full_like(ctx.tc, 1.0)
    for time_per_ex, frac, nfrac in (
        (ctx.tc, ctx.alpha, ctx.na), (ctx.tm, ctx.beta, ctx.nb)
    ):
        slack = budget / time_per_ex - nfrac
        k = np.where(slack > 0.0, frac / slack, np.inf)
        k = np.where(time_per_ex <= 0.0, 0.0, k)
        out = np.maximum(out, k)
    return out


def _batched_cost_at_throughput(
    ctx: _ProvisionCtx, throughput: np.ndarray
) -> tuple[np.ndarray, np.ndarray]:
    """Vectorized `_cost_at_throughput`: per-plan continuous cost + ks.

    Returns ``(cost (N,), ks (N, S))`` with ``cost = inf`` where any stage
    hits its Amdahl ceiling (the scalar path's ``(inf, None)``).
    ``cumsum`` is a sequential in-order fold over the stage axis, so the
    sums follow the scalar left-fold ``sum()`` (invalid slots
    contribute exactly 0.0, which is a no-op on any finite partial sum).
    """
    ks = _batched_required_k(ctx, throughput)
    ksm = np.where(ctx.mask, ks, 0.0)
    ok = np.isfinite(ksm).all(axis=1)
    rate = (ksm * ctx.stage_price).cumsum(axis=1)[:, -1]
    accel = (ksm * ctx.accel).cumsum(axis=1)[:, -1]
    ps = np.where(accel > 0.0, np.ceil(accel / 6.0), 0.0)
    rate = rate + ps * ctx.cpu_price
    cost = np.where(ok, (ctx.et_num / throughput) * rate, np.inf)
    return cost, ksm


def _batched_int_throughput(
    sb: StageBatch, k: np.ndarray, batch_size: int
) -> np.ndarray:
    """Pipeline throughput (Formula 5) under integer replica counts."""
    k_eff = np.maximum(k, 1).astype(np.float64)
    ct = (sb.oct / B_O) * batch_size * (1.0 - sb.alpha + sb.alpha / k_eff)
    dt = (sb.odt / B_O) * batch_size * (1.0 - sb.beta + sb.beta / k_eff)
    ex = np.maximum(ct, dt)
    with np.errstate(divide="ignore"):
        tp_s = np.where(sb.mask & (ex > 0.0), batch_size / np.where(ex > 0.0, ex, 1.0), np.inf)
    return tp_s.min(axis=1)


def _batched_type_counts(
    sb: StageBatch, k: np.ndarray, ps: np.ndarray, num_types: int
) -> np.ndarray:
    """(N, T) total units per resource type (Formula 7 / type_counts)."""
    counts = np.zeros((sb.batch, num_types))
    np.add.at(counts, (np.arange(sb.batch)[:, None], sb.rtype), k.astype(np.float64))
    counts[:, 0] += ps
    return counts


def batched_provision(
    sb: StageBatch,
    fleet: Sequence[ResourceType],
    job: TrainingJob,
    *,
    tau_min: np.ndarray | None = None,
    newton_iters: int = 25,
) -> BatchedProvisioning:
    """Vectorized :func:`provision` over a :class:`StageBatch`.

    ``tau_min`` optionally overrides the throughput target per plan (the
    graded-surrogate path relaxes it per plan); defaults to the job's
    ``throughput_limit`` everywhere.
    """
    N = sb.batch
    if tau_min is None:
        tau_min = np.full(N, float(job.throughput_limit))
    else:
        tau_min = np.asarray(tau_min, dtype=np.float64)

    ctx = _provision_ctx(sb, fleet, job)
    with np.errstate(all="ignore"):
        c0, _ = _batched_cost_at_throughput(ctx, tau_min)
        alive = np.isfinite(c0)

        tau = tau_min.copy()
        best_tau = tau_min.copy()
        best_cost = c0.copy()
        cc = c0  # cost at the current tau; carried across iterations
        h = np.maximum(tau_min * 1e-4, 1e-9)
        active = alive.copy()
        for _ in range(newton_iters):
            if not active.any():
                break
            cm, _ = _batched_cost_at_throughput(ctx, np.maximum(tau - h, tau_min))
            cp, _ = _batched_cost_at_throughput(ctx, tau + h)
            active &= np.isfinite(cm) & np.isfinite(cp) & np.isfinite(cc)
            g = (cp - cm) / (2 * h)
            hess = (cp - 2 * cc + cm) / (h * h)
            step = np.where(
                (hess <= 0.0) | ~np.isfinite(hess),
                -np.copysign(0.1 * tau, g),
                -g / hess,
            )
            new_tau = np.where(active, np.maximum(tau_min, tau + step), tau)
            c_new, _ = _batched_cost_at_throughput(ctx, new_tau)
            better = active & np.isfinite(c_new) & (c_new < best_cost)
            best_cost = np.where(better, c_new, best_cost)
            best_tau = np.where(better, new_tau, best_tau)
            converged = np.abs(new_tau - tau) < 1e-6 * tau_min
            tau = new_tau
            cc = c_new  # next iteration's cost-at-tau, already evaluated
            active &= ~converged

        _, ks = _batched_cost_at_throughput(ctx, best_tau)
    k_int = np.where(
        alive[:, None] & sb.mask, np.ceil(np.where(alive[:, None], ks, 0.0)), 0.0
    ).astype(np.int64)

    # Feasibility: per-type limits (Formula 10) + throughput under integer k.
    accel = (np.where(sb.rtype != 0, k_int, 0)).sum(axis=1)
    ps = np.where(accel > 0, np.ceil(accel / 6.0), 0.0).astype(np.int64)
    counts = _batched_type_counts(sb, k_int, ps, len(fleet))
    max_counts = np.array([r.max_count for r in fleet])
    limit_ok = (counts <= max_counts[None, :]).all(axis=1)
    tp = _batched_int_throughput(sb, k_int, job.batch_size)
    feasible = alive & limit_ok & (tp >= tau_min)
    return BatchedProvisioning(k=k_int, ps_cores=ps, feasible=feasible)


def provision_sta_ratio(
    stages: Sequence[Stage],
    fleet: Sequence[ResourceType],
    job: TrainingJob,
    *,
    with_ps: bool = False,
) -> ProvisioningPlan | None:
    """StaRatio / StaPSRatio: per-stage minimum k to meet the throughput
    limit *independently* (no load balancing), CPU stages sized at 6 cores
    per accelerator unit (AIBox's 1:6 in-server ratio), plus 6 PS cores
    per accelerator for StaPSRatio."""
    n_accel = 0.0
    k_int: list[int] = []
    for s in stages:
        k = required_k(s, job.throughput_limit, job.batch_size)
        if not math.isfinite(k):
            return None
        k_int.append(int(math.ceil(k)))
        if s.resource_type != 0:
            n_accel += k_int[-1]
    # force the static CPU:GPU ratio on CPU stages
    if n_accel:
        for i, s in enumerate(stages):
            if s.resource_type == 0:
                k_int[i] = max(k_int[i], int(math.ceil(6.0 * n_accel)))
    ps = int(math.ceil(6.0 * n_accel)) if with_ps and n_accel else 0
    counts: dict[int, int] = {}
    for s, k in zip(stages, k_int):
        counts[s.resource_type] = counts.get(s.resource_type, 0) + k
    counts[0] = counts.get(0, 0) + ps
    for t, n in counts.items():
        if n > fleet[t].max_count:
            return None
    return ProvisioningPlan(k=tuple(k_int), ps_cores=ps)
