"""Soft cost model on the device — Formulas 1–7 and the graded surrogate in
PyTorch (the port of ``repro.core.jax_cost``).

This is the fused RL search's reward function: tensor code that mirrors
the NumPy batched path (``plan.batched_build_stages`` →
``provision.batched_provision`` → ``cost_model.batched_soft_plan_cost``)
so that one search round — sampling, scoring, the REINFORCE update —
runs on the device with no host round trip.  The NumPy path stays the
oracle; ``tests/test_torch_scheduler.py`` holds this module to it and to
``repro.core.jax_cost``.

* **A model axis.**  Every tensor carries a leading model axis ``M``, so
  ``RLScheduler.schedule_many`` scores several models of one fleet size
  in one pass: :class:`CostTensors` fields are ``(M, L, T)``, ``(M, L)``
  and ``(M, T)``, actions ``(M, N, L)``.  :func:`soft_cost` also takes a
  single model's tensors and ``(N, L)`` actions.
* **Static shapes.**  Stage counts vary per plan, so every per-stage
  tensor is padded to ``S = L`` (a plan has at most one stage per layer)
  with a validity mask.  A per-layer mask pads several models to one
  ``L``: padded layers open no stage and add no OCT/ODT.
* **No host syncs.**  The Newton iteration runs its fixed
  :data:`NEWTON_ITERS` trips with masked updates, and the graded
  surrogate re-provisions every plan and selects with ``torch.where``
  (the NumPy path retires converged plans and re-provisions only the
  infeasible subset).  Nothing calls ``.item()``, branches on a tensor or
  makes a shape from data, so a caller can enqueue many rounds and read
  the results once.
* **Few launches.**  The device time is thousands of tiny kernels, so
  independent evaluations share one: the true and the relaxed
  provisioning run as one :func:`provision` over the plans stacked
  twice, and each Newton trip prices ``τ - h`` and ``τ + h`` in one
  call.  Every plan's arithmetic is unchanged.
* **Precision.**  Cost tensors are float64 on the given device; results
  agree with the oracle to float64 rounding (sums run in another order).
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from repro_torch.core.cost_model import TrainingJob
from repro_torch.core.profiles import B_O, LayerProfile
from repro_torch.core.resources import ResourceType
from repro_torch.device import resolve_device

#: fixed trip count of the Newton iteration — matches the NumPy default
NEWTON_ITERS = 25

_F64 = torch.float64


class CostTensors(NamedTuple):
    """Device-resident constants for one job per model: per-layer profile
    tables, fleet prices and limits, job scalars.  Stack several with
    :func:`stack_cost_tensors` to score models side by side."""

    oct: torch.Tensor        # (M, L, T) per-layer OCT per resource type
    sync: torch.Tensor       # (M, L, T) per-layer gradient/param sync ODT
    act: torch.Tensor        # (M, L, T) per-layer activation hand-off ODT
    alpha: torch.Tensor      # (M, L) Amdahl compute fraction
    beta: torch.Tensor       # (M, L) Amdahl comm fraction
    lmask: torch.Tensor      # (M, L) bool — False on padded layer slots
    price: torch.Tensor      # (M, T) price per second
    maxc: torch.Tensor       # (M, T) per-type unit limits (Formula 10)
    batch: torch.Tensor      # (M,) global batch size B
    et_num: torch.Tensor     # (M,) num_epochs * num_examples
    tau_limit: torch.Tensor  # (M,) throughput_limit (Formula 10)

    @property
    def num_types(self) -> int:
        return self.oct.shape[-1]


def cost_tensors(
    profiles: Sequence[LayerProfile],
    fleet: Sequence[ResourceType],
    job: TrainingJob,
    *,
    pad_to: int | None = None,
    device=None,
) -> CostTensors:
    """:class:`CostTensors` of one model (``M = 1``) in float64 on
    ``device`` (default ``cuda``), the layer axis optionally padded."""
    L = len(profiles)
    P = pad_to if pad_to is not None else L
    if P < L:
        raise ValueError(f"pad_to={P} < {L} layers")
    T = len(fleet)
    dev = resolve_device(device)

    def lay(get):
        a = np.zeros((P, T))
        for i, p in enumerate(profiles):
            a[i] = get(p)
        return a

    alpha = np.zeros(P)
    beta = np.zeros(P)
    for i, p in enumerate(profiles):
        alpha[i], beta[i] = p.alpha, p.beta

    def t(x, dtype=_F64):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=dev)[None]

    return CostTensors(
        oct=t(lay(lambda p: p.oct)),
        sync=t(lay(lambda p: p.odt_sync)),
        act=t(lay(lambda p: p.odt_act)),
        alpha=t(alpha),
        beta=t(beta),
        lmask=t(np.arange(P) < L, torch.bool),
        price=t([r.price_per_sec for r in fleet]),
        maxc=t([float(r.max_count) for r in fleet]),
        batch=t(float(job.batch_size)),
        et_num=t(float(job.num_epochs * job.num_examples)),
        tau_limit=t(float(job.throughput_limit)),
    )


def stack_cost_tensors(cts: Sequence[CostTensors]) -> CostTensors:
    """Concatenate single-model tensors (same padded ``L`` and ``T``)
    along the model axis."""
    return CostTensors(*(torch.cat(xs) for xs in zip(*cts)))


class _Stages(NamedTuple):
    """Per-stage tensors for ``(M, N)`` plans, padded to ``S = L``
    (cf. ``plan.StageBatch``), plus the loop-invariant terms the
    provisioning search reuses (cf. ``provision._ProvisionCtx``)."""

    rtype: torch.Tensor        # (M, N, S) int64 resource type (0 if invalid)
    oct: torch.Tensor          # (M, N, S)
    odt: torch.Tensor          # (M, N, S)
    alpha: torch.Tensor        # (M, N, S)
    beta: torch.Tensor         # (M, N, S)
    mask: torch.Tensor         # (M, N, S) bool
    tc: torch.Tensor           # oct / B_o — per-example compute time
    tm: torch.Tensor           # odt / B_o — per-example comm time
    na: torch.Tensor           # 1 - alpha
    nb: torch.Tensor           # 1 - beta
    stage_price: torch.Tensor  # price/s per stage (0 in invalid slots)
    accel: torch.Tensor        # 1.0 where the stage is on an accelerator
    c_free: torch.Tensor       # tc <= 0: compute needs no replica
    m_free: torch.Tensor       # tm <= 0: communication needs no replica


def _twice(st: _Stages) -> _Stages:
    """``st`` with its plans stacked twice along the plan axis."""
    return _Stages(*(x.repeat(1, 2, 1) for x in st))


def _per_plan(x: torch.Tensor, n: int) -> torch.Tensor:
    """(M, L, T) → (M, N, L, T) view, broadcast over ``n`` plans."""
    return x[:, None].expand(x.shape[0], n, *x.shape[1:])


def build_stages(ct: CostTensors, actions: torch.Tensor) -> _Stages:
    """Fuse consecutive same-type layers into stages (``plan.build_stages``).

    ``actions`` is ``(M, N, L)`` int64; padded layer slots (``ct.lmask``
    False) never open a stage and contribute zero OCT/ODT.  Segment sums
    are one-hot einsums, as in the reference.
    """
    M, N, L = actions.shape
    lm = ct.lmask[:, None, :]                        # (M, 1, L)
    lmf = lm.to(_F64)
    n_layers = ct.lmask.sum(-1)                      # (M,)
    idx = actions[..., None]

    def take(x):                                     # x[m, l, a[m, n, l]]
        return torch.gather(_per_plan(x, N), 3, idx)[..., 0] * lmf

    oct_l, sync_l, act_l = take(ct.oct), take(ct.sync), take(ct.act)

    first = torch.ones((M, N, 1), dtype=torch.bool, device=actions.device)
    change = torch.cat([first, actions[..., 1:] != actions[..., :-1]],
                       -1) & lm
    sid = torch.cumsum(change, -1) - 1               # (M, N, L) stage id
    # last layer of a stage: the next layer opens a new stage, or it is the
    # last *valid* layer (padded slots have change False, so the real last
    # layer needs the explicit test)
    nxt = torch.cat([change[..., 1:], torch.zeros_like(first)], -1)
    lay = torch.arange(L, device=actions.device)
    is_last = (nxt | (lay == (n_layers - 1)[:, None, None])) & lm

    onehot = (sid[..., None] == lay).to(_F64)        # (M, N, L, S)

    def seg(v):
        return torch.einsum("mnl,mnls->mns", v, onehot)

    oct_s = seg(oct_l)
    odt_s = seg(sync_l) + seg(torch.where(is_last, act_l, 0.0))
    w = torch.clamp_min(oct_s, 1e-30)
    alpha_s = seg(ct.alpha[:, None, :] * oct_l) / w
    beta_s = seg(ct.beta[:, None, :] * oct_l) / w
    # the stage's type is its first layer's action (change marks exactly
    # one layer per stage); an integer sum, so exact in any order
    rtype = torch.zeros_like(actions).scatter_add_(-1, sid, actions * change)
    smask = lay < (sid[..., -1:] + 1)
    price = torch.gather(_per_plan(ct.price, N), 2, rtype)
    tc, tm = oct_s / B_O, odt_s / B_O
    return _Stages(
        rtype=rtype, oct=oct_s, odt=odt_s, alpha=alpha_s, beta=beta_s,
        mask=smask, tc=tc, tm=tm, na=1.0 - alpha_s, nb=1.0 - beta_s,
        stage_price=torch.where(smask, price, 0.0),
        accel=torch.where(smask & (rtype != 0), 1.0, 0.0),
        c_free=tc <= 0.0, m_free=tm <= 0.0,
    )


def _finite(x: torch.Tensor) -> torch.Tensor:
    """``torch.isfinite`` in two kernels instead of four (NaN and ±inf
    both fail ``|x| < inf``)."""
    return x.abs() < torch.inf


def _required_k(st: _Stages, tau: torch.Tensor) -> torch.Tensor:
    """Vectorized ``provision.required_k``: (M, N, S) continuous k at
    per-plan target throughput ``tau`` (inf past a stage's Amdahl
    ceiling)."""
    budget = 1.0 / tau[..., None]
    ks = []
    for time_per_ex, frac, nfrac, free in (
            (st.tc, st.alpha, st.na, st.c_free),
            (st.tm, st.beta, st.nb, st.m_free)):
        slack = budget / time_per_ex - nfrac
        k = torch.where(slack > 0.0, frac / slack, torch.inf)
        ks.append(torch.where(free, 0.0, k))
    return torch.maximum(torch.clamp_min(ks[0], 1.0), ks[1])


def _cost_at_tau(ct: CostTensors, st: _Stages, tau: torch.Tensor):
    """Continuous-relaxation cost at per-plan ``tau`` → (cost (M, N),
    ks (M, N, S)); inf where a stage hits its Amdahl ceiling.  ``cumsum``
    folds the stages in order, as the NumPy path does."""
    ksm = torch.where(st.mask, _required_k(st, tau), 0.0)
    ok = _finite(ksm).all(-1)
    rate = torch.cumsum(ksm * st.stage_price, -1)[..., -1]
    accel = torch.cumsum(ksm * st.accel, -1)[..., -1]
    ps = torch.where(accel > 0.0, torch.ceil(accel / 6.0), 0.0)
    rate = rate + ps * ct.price[:, :1]
    cost = torch.where(ok, (ct.et_num[:, None] / tau) * rate, torch.inf)
    return cost, ksm


def _int_throughput(ct: CostTensors, st: _Stages,
                    k: torch.Tensor) -> torch.Tensor:
    """Pipeline throughput (Formula 5) under integer replica counts."""
    batch = ct.batch[:, None, None]
    k_eff = torch.clamp_min(k, 1.0)
    cts = st.tc * batch * (st.na + st.alpha / k_eff)
    dts = st.tm * batch * (st.nb + st.beta / k_eff)
    ex = torch.maximum(cts, dts)
    pos = ex > 0.0
    tp_s = torch.where(st.mask & pos, batch / torch.where(pos, ex, 1.0),
                       torch.inf)
    return tp_s.amin(-1)


def _type_counts(ct: CostTensors, st: _Stages, k: torch.Tensor,
                 ps: torch.Tensor) -> torch.Tensor:
    """(M, N, T) total units per resource type, PS cores on type 0.  The
    counts are whole numbers, so the scattered sum is exact in any
    order."""
    M, N, _ = k.shape
    counts = torch.zeros((M, N, ct.num_types), dtype=k.dtype,
                         device=k.device).scatter_add_(-1, st.rtype, k)
    counts[..., 0] += ps
    return counts


class _Provisioning(NamedTuple):
    k: torch.Tensor         # (M, N, S) integer replica counts, float64
    ps: torch.Tensor        # (M, N) PS cores
    feasible: torch.Tensor  # (M, N) bool


def provision(ct: CostTensors, st: _Stages,
              tau_min: torch.Tensor) -> _Provisioning:
    """Vectorized ``provision.batched_provision``: Newton on the
    throughput target τ (:data:`NEWTON_ITERS` fixed trips, masked
    updates), integer rounding, Formula-10 limit and throughput checks."""
    c0, _ = _cost_at_tau(ct, st, tau_min)
    alive = _finite(c0)
    h = torch.clamp_min(tau_min * 1e-4, 1e-9)
    h2, hh, tol = 2 * h, h * h, 1e-6 * tau_min
    st2 = _twice(st)
    tau, best_tau, best_cost, cc, active = tau_min, tau_min, c0, c0, alive
    for _ in range(NEWTON_ITERS):
        cmp, _ = _cost_at_tau(ct, st2, torch.cat(
            [torch.maximum(tau - h, tau_min), tau + h], 1))
        cm, cp = cmp.chunk(2, 1)
        active = active & _finite(cm) & _finite(cp) & _finite(cc)
        g = (cp - cm) / h2
        hess = (cp - 2 * cc + cm) / hh
        step = torch.where((hess <= 0.0) | ~_finite(hess),
                           -torch.copysign(0.1 * tau, g), -g / hess)
        new_tau = torch.where(active, torch.maximum(tau_min, tau + step), tau)
        c_new, _ = _cost_at_tau(ct, st, new_tau)
        better = active & _finite(c_new) & (c_new < best_cost)
        best_cost = torch.where(better, c_new, best_cost)
        best_tau = torch.where(better, new_tau, best_tau)
        active = active & ~((new_tau - tau).abs() < tol)
        tau, cc = new_tau, c_new
    _, ks = _cost_at_tau(ct, st, best_tau)
    live = alive[..., None]
    k_int = torch.where(live & st.mask,
                        torch.ceil(torch.where(live, ks, 0.0)), 0.0)
    accel = torch.where(st.rtype != 0, k_int, 0.0).sum(-1)
    ps = torch.where(accel > 0.0, torch.ceil(accel / 6.0), 0.0)
    counts = _type_counts(ct, st, k_int, ps)
    limit_ok = (counts <= ct.maxc[:, None, :]).all(-1)
    tp = _int_throughput(ct, st, k_int)
    return _Provisioning(k=k_int, ps=ps,
                         feasible=alive & limit_ok & (tp >= tau_min))


def _monetary(ct: CostTensors, st: _Stages, k: torch.Tensor,
              ps: torch.Tensor) -> torch.Tensor:
    """Formulas 5–7 for integer provisioning, no constraint checks."""
    et = ct.et_num[:, None] / _int_throughput(ct, st, k)
    counts = _type_counts(ct, st, k, ps)
    rate = torch.cumsum(counts * ct.price[:, None, :], -1)[..., -1]
    return et * rate


class SoftCost(NamedTuple):
    """Per-plan results of :func:`soft_cost` — the device analogue of
    ``(batched_plan_cost.costs, soft)`` plus the feasibility mask that
    lets the host reconstruct exact true costs (feasible ⇒ cost == soft;
    infeasible ⇒ cost == inf)."""

    soft: torch.Tensor      # graded surrogate (finite unless degenerate)
    cost: torch.Tensor      # true cost, inf where infeasible
    feasible: torch.Tensor  # bool


def soft_cost(ct: CostTensors, actions: torch.Tensor) -> SoftCost:
    """``cost_model.batched_soft_plan_cost`` on the device.

    ``actions`` is ``(M, N, L)`` against ``M``-model tensors, or ``(N,
    L)`` against single-model ones (results then drop the model axis).
    The relaxed re-provisioning runs for every plan and ``torch.where``
    selects; feasible plans' relaxed branch is computed and discarded.
    """
    single = actions.dim() == 2
    if single:
        actions = actions[None]
    actions = actions.to(torch.int64)
    M, N, _ = actions.shape
    st = build_stages(ct, actions)
    tau_limit = ct.tau_limit[:, None]

    # the graded surrogate for infeasible plans re-provisions at a relaxed
    # target: half the max achievable pipeline throughput (every stage at
    # its type's limit); both provisionings run as one, the true one on
    # the first N rows, the relaxed one on the last N
    maxc = torch.gather(_per_plan(ct.maxc, N), 2, st.rtype)
    tp_max = _int_throughput(ct, st, torch.where(st.mask, maxc, 0.0))
    relaxed = torch.minimum(tp_max * 0.5, tau_limit)
    st2 = _twice(st)
    bp2 = provision(ct, st2, torch.cat([tau_limit.expand(M, N), relaxed], 1))
    money, base = _monetary(ct, st2, bp2.k, bp2.ps).chunk(2, 1)
    feasible, feasible_r = bp2.feasible.chunk(2, 1)
    cost = torch.where(feasible, money, torch.inf)
    # scale the relaxed cost by the squared constraint violation
    violation = torch.clamp_min(tau_limit / torch.clamp_min(tp_max, 1e-9),
                                1.0)
    graded = base * 10.0 * violation**2
    soft_infeas = torch.where(feasible_r & (tp_max > 0), graded, 1e15)
    out = SoftCost(soft=torch.where(feasible, cost, soft_infeas),
                   cost=cost, feasible=feasible)
    return SoftCost(*(x[0] for x in out)) if single else out


def torch_soft_plan_cost(
    assignments: np.ndarray,
    profiles: Sequence[LayerProfile],
    fleet: Sequence[ResourceType],
    job: TrainingJob,
    *,
    device=None,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Host wrapper: (soft, cost, feasible) NumPy arrays for an ``(N, L)``
    assignment batch scored on ``device`` (default ``cuda``)."""
    ct = cost_tensors(profiles, fleet, job, device=device)
    acts = torch.as_tensor(np.asarray(assignments, dtype=np.int64),
                           device=ct.oct.device)
    out = soft_cost(ct, acts)
    return (out.soft.cpu().numpy(), out.cost.cpu().numpy(),
            out.feasible.cpu().numpy())
