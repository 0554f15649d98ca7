"""Reinforcement-learning scheduler (HeterPS §5.2, Algorithm 1; the port of
``repro.core.schedulers.rl``).

REINFORCE (Williams) over the LSTM policy of ``policy.py``:

* each round samples ``N`` scheduling plans from the current policy;
* each plan's reward is the (negated, log-scaled) monetary cost from the
  cost model, with the provisioning module invoked inside the evaluation
  (Algorithm 1 Line 5 — ``R_n ← Cost(SP)``);
* a moving-average baseline ``b ← (1-γ)·b + γ/N·ΣR_n`` reduces variance
  (Formula 15, Line 8);
* parameters update by gradient ascent (Formula 16) with Adam (plain SGD
  via ``optimizer="sgd"``).

Two implementations of the search loop:

* **fused** (default): sampling, the soft-cost reward
  (``core/torch_cost.py``), baseline and advantage, the REINFORCE gradient
  (autograd through the sampling pass) and the optimizer step all run on
  the device.  A chunk of ``chunk_rounds`` rounds is enqueued with no host
  sync: the best cost, the rounds since it improved and the stop flag
  stay on the device.  The host reads each chunk's actions, soft costs,
  feasibility and stop flags once, back-fills the :class:`CostCache`
  (``seed_from_device``) and stops when every model has flagged.
  ``schedule_many`` runs several models of one fleet size side by side on
  a leading model axis (layers padded to the group's maximum, with a
  mask).
* **unfused** (``fused=False``): one round at a time, scored by the NumPy
  ``batched_soft_plan_cost``; the oracle the fused path is held to.

Both draw one Gumbel tensor (plans, layers, types) a round from a CPU
``torch.Generator`` seeded with ``seed`` (after the policy's initial
weights), so a seed gives the same draws on every device and in both
loops, and every model of a group sees the same draws.
"""

from __future__ import annotations

import math
import time
from typing import Sequence

import numpy as np
import torch

from repro_torch.core import torch_cost
from repro_torch.core.cost_model import plan_cost
from repro_torch.core.plan import SchedulingPlan
from repro_torch.core.schedulers import policy as pol
from repro_torch.core.schedulers.base import CostCache, ScheduleResult, Scheduler
from repro_torch.device import resolve_device


@torch.no_grad()
def _adam_update(params, grads, state, lr, b1=0.9, b2=0.999, eps=1e-8):
    """One Adam step *in place* on ``params`` — ASCENT (reward gradients
    point uphill).  ``state`` is ``(m, v, t)``; the bias corrections are
    float32, as in the reference."""
    m, v, t = state
    t = t + 1
    m = [b1 * a + (1 - b1) * g for a, g in zip(m, grads)]
    v = [b2 * a + (1 - b2) * g * g for a, g in zip(v, grads)]
    c1 = 1.0 - np.float32(b1) ** t
    c2 = 1.0 - np.float32(b2) ** t
    for p, a, b in zip(params, m, v):
        p.copy_(p + lr * (a / c1) / (torch.sqrt(b / c2) + eps))
    return m, v, t


class RLScheduler(Scheduler):
    """``cell="lstm"`` is HeterPS; ``cell="rnn"`` is the RL-RNN baseline.

    The search runs on ``device`` (default ``cuda``; ``"cpu"`` for the
    plain path): the policy always, and in the fused loop the cost model
    too."""

    def __init__(
        self,
        cell: str = "lstm",
        hidden: int = 64,
        rounds: int = 150,
        plans_per_round: int = 32,
        lr: float = 0.03,
        gamma: float = 0.3,
        temperature: float = 2.0,
        optimizer: str = "adam",
        seed: int = 0,
        early_stop_rounds: int = 50,
        fused: bool = True,
        chunk_rounds: int = 25,
        device=None,
    ):
        if cell not in ("lstm", "rnn"):
            raise ValueError(f"cell must be 'lstm' or 'rnn', got {cell!r}")
        self.cell = cell
        self.name = "RL-LSTM" if cell == "lstm" else "RL-RNN"
        self.hidden = hidden
        self.rounds = rounds
        self.plans_per_round = plans_per_round
        self.lr = lr
        self.gamma = gamma
        self.temperature = temperature
        self.optimizer = optimizer
        self.seed = seed
        self.early_stop_rounds = early_stop_rounds
        self.fused = fused
        self.chunk_rounds = chunk_rounds
        self.device = resolve_device(device)

    # -- shared pieces --------------------------------------------------------

    def _init_policy(self, gen: torch.Generator, in_dim: int, T: int,
                     models: int) -> pol.Policy:
        return pol.init_policy(self.cell, in_dim, self.hidden, T,
                               models=models, generator=gen,
                               device=self.device)

    def _noise(self, gen: torch.Generator, shape) -> torch.Tensor:
        """One round's Gumbel draw (plans, layers, types), on the CPU."""
        return pol.gumbel_noise(gen, shape)

    def _step(self, policy, grads, opt):
        if self.optimizer == "adam":
            return _adam_update(policy.params(), grads, opt, self.lr)
        with torch.no_grad():
            for p, g in zip(policy.params(), grads):
                p.copy_(p + self.lr * g)
        return opt

    def _anchored_cache(self, profiles, fleet, job, warm=()) -> CostCache:
        """Cache pre-seeded with the warm-start anchors: the homogeneous
        plans (Algorithm 1 "may also generate a homogeneous scheduling
        plan") and the AIBox heuristic (data-intensive layers → type 0).
        ``warm`` adds caller-supplied assignment vectors — e.g. the
        re-planner's incumbent plan — to the anchor set (malformed entries
        are ignored).  Anchors are oracle-scored here and the final plan is
        best-of(search ∪ anchors), so RL never returns worse than the
        static heuristics it subsumes, nor worse than any warm start."""
        T, L = len(fleet), len(profiles)
        cache = CostCache(profiles, fleet, job)
        anchors = [(t,) * L for t in range(T)]
        if T > 1:
            anchors.append(tuple(
                0 if p.kind in ("embedding", "nce") else 1 for p in profiles
            ))
        for w in warm:
            a = tuple(int(x) for x in w)
            if len(a) == L and all(0 <= x < T for x in a):
                anchors.append(a)
        cache.batch_call(anchors)
        return cache

    def _select_plan(self, cache, policy, feats, num_layers):
        """Final decision: argmax decode (§5.2) — but never return
        something worse than the best plan seen during the search.

        The winner is re-verified against the NumPy oracle before being
        returned: fused-search memo entries are device-scored, and on an
        exact constraint boundary float64 sums in another order can flip
        feasibility between the device and NumPy.  A disagreement pins
        the oracle verdict into the cache and re-selects, so the anchor
        guarantee (anchors are always oracle-scored) survives.
        """
        ga = pol.greedy(policy, feats)[0].cpu().numpy()
        greedy = tuple(int(a) for a in ga[:num_layers])
        greedy_cost = cache(greedy)
        while True:
            best_seen, best_seen_cost = cache.best()
            plan = greedy if greedy_cost <= best_seen_cost else best_seen
            if not cache.device_seeded:
                break  # every entry is oracle-written: nothing to verify
            oracle_cost, _ = plan_cost(
                SchedulingPlan(plan), cache.profiles, cache.fleet, cache.job
            )
            if math.isfinite(oracle_cost) or not math.isfinite(
                min(greedy_cost, best_seen_cost)
            ):
                break  # oracle agrees, or nothing feasible exists anyway
            cache.pin_true(plan, oracle_cost)
            if plan == greedy:
                greedy_cost = oracle_cost
        return plan, greedy_cost

    # -- search entry points --------------------------------------------------

    def _search(self, profiles, fleet, job):
        if self.fused:
            return self._fused_search([(profiles, fleet, job)])[0]
        return self._search_unfused(profiles, fleet, job)

    def schedule_many(
        self, specs: Sequence[tuple], warm_starts: Sequence | None = None
    ) -> list[ScheduleResult]:
        """Schedule several ``(profiles, fleet, job)`` workloads, one fused
        search per fleet-size group.

        Models are grouped by resource-type count (padding the *type* axis
        would distort sampling), layer features are padded to the group's
        largest layer count with a mask, and each group runs as one search
        with a model axis.  Per-model results are identical in structure
        to ``schedule()``'s.  With ``fused=False`` this is a sequential
        loop.

        ``warm_starts[i]``, when given, is a sequence of assignment vectors
        seeded as oracle-scored anchors for ``specs[i]`` — the reactive
        re-planner passes its incumbent plan here, so the result is never
        worse than the plan it might replace.
        """
        warms = ([() for _ in specs] if warm_starts is None
                 else [tuple(w) if w else () for w in warm_starts])
        if len(warms) != len(specs):
            raise ValueError(f"{len(warms)} warm starts for {len(specs)} "
                             "specs")
        results: dict[int, ScheduleResult] = {}
        if not self.fused:
            for i, (p, f, j) in enumerate(specs):
                t0 = time.perf_counter()
                plan, evals, extra = self._search_unfused(
                    p, f, j, warm=warms[i])
                wall = time.perf_counter() - t0
                cost, prov = plan_cost(plan, p, f, j)
                results[i] = ScheduleResult(
                    plan=plan, prov=prov, cost=cost, wall_time_s=wall,
                    evaluations=evals, extra=extra,
                )
            return [results[i] for i in range(len(specs))]
        groups: dict[int, list[int]] = {}
        for i, (_, fleet, _) in enumerate(specs):
            groups.setdefault(len(fleet), []).append(i)
        for idxs in groups.values():
            t0 = time.perf_counter()
            outs = self._fused_search([specs[i] for i in idxs],
                                      warm_starts=[warms[i] for i in idxs])
            wall = time.perf_counter() - t0
            for i, (plan, evals, extra) in zip(idxs, outs):
                profiles, fleet, job = specs[i]
                cost, prov = plan_cost(plan, profiles, fleet, job)
                results[i] = ScheduleResult(
                    plan=plan, prov=prov, cost=cost, wall_time_s=wall,
                    evaluations=evals, extra=extra,
                )
        return [results[i] for i in range(len(specs))]

    # -- fused implementation -------------------------------------------------

    def _fused_search(self, specs, warm_starts=None):
        """Chunked on-device REINFORCE for one or more same-fleet-size
        models.  Returns ``[(plan, evaluations, extra), ...]`` aligned
        with ``specs``."""
        M = len(specs)
        T = len(specs[0][1])
        if any(len(f) != T for _, f, _ in specs):
            raise ValueError("group specs by fleet size")
        dev = self.device
        Lmax = max(len(p) for p, _, _ in specs)
        num_layers = [len(p) for p, _, _ in specs]
        warms = warm_starts if warm_starts is not None else [()] * M
        caches = [self._anchored_cache(p, f, j, warm=w)
                  for (p, f, j), w in zip(specs, warms)]

        fm = [pol.layer_features(p, pad_to=Lmax, return_mask=True)
              for p, _, _ in specs]
        feats = torch.as_tensor(np.stack([f for f, _ in fm]), device=dev)
        mask = torch.as_tensor(np.stack([m for _, m in fm]), device=dev)
        ct = torch_cost.stack_cost_tensors([
            torch_cost.cost_tensors(p, f, j, pad_to=Lmax, device=dev)
            for p, f, j in specs])
        gen = torch.Generator().manual_seed(self.seed)
        policy = self._init_policy(gen, feats.shape[2] + T, T, M)
        params = policy.params()
        opt = ([torch.zeros_like(p) for p in params],
               [torch.zeros_like(p) for p in params], 0)
        b = torch.zeros(M, dtype=torch.float64, device=dev)
        # device-side early-stop state: best soft cost so far and rounds
        # since it last improved
        best = torch.full((M,), math.inf, dtype=torch.float64, device=dev)
        since = torch.zeros(M, dtype=torch.int64, device=dev)
        N = self.plans_per_round

        histories = [[] for _ in range(M)]
        stopped = [False] * M
        final = [None] * M  # per-model params after its final round
        chunk_s: list[float] = []
        chunk_rounds: list[int] = []
        rounds_done = 0
        while rounds_done < self.rounds and not all(stopped):
            C = min(max(1, self.chunk_rounds), self.rounds - rounds_done)
            t0 = time.perf_counter()
            noise = torch.stack([self._noise(gen, (N, Lmax, T))
                                 for _ in range(C)]).to(dev)
            snaps, acts, softs, feas, stops = [], [], [], [], []
            for c in range(C):
                actions, logps = pol.sample(policy, feats, noise[c],
                                            temperature=self.temperature,
                                            mask=mask)
                with torch.no_grad():
                    sc = torch_cost.soft_cost(ct, actions)
                    rewards = -torch.log10(sc.soft + 1e-12)
                    rmean = rewards.mean(-1)
                    if rounds_done + c == 0:
                        b = rmean     # Line 1: b ← the first round's mean
                    adv = (rewards - b[:, None]).to(torch.float32)
                # d mean(adv · logp) / dθ, through the sampling pass
                grads = torch.autograd.grad(logps, params,
                                            grad_outputs=adv / N)
                opt = self._step(policy, grads, opt)
                with torch.no_grad():
                    b = (1 - self.gamma) * b + self.gamma * rmean  # Line 8
                    # strict improvement beyond 1e-12 resets the clock
                    round_best = sc.soft.amin(-1)
                    improved = round_best < best - 1e-12
                    since = torch.where(improved, 0, since + 1)
                    best = torch.where(improved, round_best, best)
                    stops.append(since >= self.early_stop_rounds)
                snaps.append([p.detach().clone() for p in params])
                acts.append(actions)
                softs.append(sc.soft)
                feas.append(sc.feasible)
            # the chunk's one read of the device
            acts_h = torch.stack(acts, 1).cpu().numpy()
            softs_h = torch.stack(softs, 1).cpu().numpy()
            feas_h = torch.stack(feas, 1).cpu().numpy()
            stops_h = torch.stack(stops, 1).cpu().numpy()

            for m in range(M):
                if stopped[m]:
                    continue
                final_c = C - 1
                for c in range(C):
                    caches[m].seed_from_device(
                        acts_h[m, c, :, : num_layers[m]],
                        softs_h[m, c], feas_h[m, c],
                    )
                    histories[m].append(float(softs_h[m, c].min()))
                    if stops_h[m, c]:
                        stopped[m], final_c = True, c
                        break
                final[m] = [x[m:m + 1] for x in snaps[final_c]]
            rounds_done += C
            chunk_s.append(time.perf_counter() - t0)
            chunk_rounds.append(C)

        steady_s, steady_r = sum(chunk_s[1:]), sum(chunk_rounds[1:])
        per_round = [s / r for s, r in zip(chunk_s[1:], chunk_rounds[1:])]
        # the first chunk's time beyond a steady chunk of its length
        first_extra = max(0.0, chunk_s[0] - chunk_rounds[0] * min(per_round)) \
            if per_round else 0.0

        out = []
        for m in range(M):
            final_policy = pol.Policy(self.cell, dict(zip(policy.names(),
                                                          final[m])))
            plan, greedy_cost = self._select_plan(
                caches[m], final_policy, feats[m:m + 1], num_layers[m])
            out.append((
                SchedulingPlan(plan),
                caches[m].evaluations,
                {
                    "rounds": len(histories[m]),
                    "history": histories[m],
                    "greedy_cost": greedy_cost,
                    "fused": True,
                    "vmapped_models": M,
                    "compile_s": first_extra,
                    "rounds_per_s": steady_r / steady_s if steady_s > 0
                    else None,
                    "chunk_s": chunk_s,
                    "device": str(dev),
                },
            ))
        return out

    # -- unfused (per-round NumPy-scored) implementation ----------------------

    def _search_unfused(self, profiles, fleet, job, warm=()):
        T, L = len(fleet), len(profiles)
        dev = self.device
        feats = torch.as_tensor(pol.layer_features(profiles),
                                device=dev)[None]
        gen = torch.Generator().manual_seed(self.seed)
        policy = self._init_policy(gen, feats.shape[2] + T, T, 1)
        params = policy.params()
        opt = ([torch.zeros_like(p) for p in params],
               [torch.zeros_like(p) for p in params], 0)

        cache = self._anchored_cache(profiles, fleet, job, warm=warm)
        b = 0.0  # moving-average baseline (Algorithm 1, Line 1)
        b_init = False
        best_cost, best_since = float("inf"), 0
        history = []

        t_loop = time.perf_counter()
        for rnd in range(self.rounds):
            g = self._noise(gen, (self.plans_per_round, L, T)).to(dev)
            with torch.no_grad():
                actions, _ = pol.sample(policy, feats, g,
                                        temperature=self.temperature)
            acts_np = actions[0].cpu().numpy()
            # graded surrogate: infeasible plans get finite costs ordered
            # by violation, so the REINFORCE signal survives a round of
            # infeasible plans; the round is scored in one vectorized pass
            costs = cache.batch_soft(acts_np)
            # reward: negative log-cost — scale-free across models/fleets
            rewards = -np.log10(costs + 1e-12)
            if not b_init:
                b, b_init = float(rewards.mean()), True
            adv = torch.as_tensor(np.asarray(rewards - b, dtype=np.float32),
                                  device=dev)[None]
            grads = pol.reinforce_grad(policy, feats, actions, adv)
            opt = self._step(policy, grads, opt)
            # Line 8: moving-average baseline update
            b = (1 - self.gamma) * b + self.gamma * float(rewards.mean())

            round_best = float(np.min(costs))
            history.append(round_best)
            if round_best < best_cost - 1e-12:
                best_cost, best_since = round_best, 0
            else:
                best_since += 1
            if best_since >= self.early_stop_rounds:
                break
        t_loop = time.perf_counter() - t_loop

        plan, greedy_cost = self._select_plan(cache, policy, feats, L)
        return (
            SchedulingPlan(plan),
            cache.evaluations,
            {"rounds": rnd + 1, "history": history, "greedy_cost": greedy_cost,
             "fused": False,
             # round-loop throughput only (no anchors/greedy/final eval),
             # comparable to the fused path's rounds_per_s
             "rounds_per_s": (rnd + 1) / t_loop if t_loop > 0 else None,
             "device": str(dev)},
        )
