"""Bayesian-optimization scheduling baseline (HeterPS §6.2, [10]; the
port's NumPy copy of ``repro.core.schedulers.bayesian``).

A GP surrogate with a Hamming-distance RBF kernel over the discrete plan
space; expected-improvement acquisition maximized over a random candidate
pool.  The paper notes BO "may add much randomness to the scheduling
process" — visible here as seed-to-seed cost variance.
"""

from __future__ import annotations

import math
import random

import numpy as np

from repro_torch.core.schedulers.base import CostCache, Scheduler


def _hamming_kernel(X: np.ndarray, Y: np.ndarray, ell: float) -> np.ndarray:
    # X: (n, L), Y: (m, L) integer plans
    d = (X[:, None, :] != Y[None, :, :]).mean(-1)
    return np.exp(-d / ell)


class BayesianScheduler(Scheduler):
    name = "BO"

    def __init__(
        self,
        num_iters: int = 48,
        init_random: int = 12,
        candidates: int = 256,
        ell: float = 0.3,
        noise: float = 1e-6,
        seed: int = 0,
    ):
        self.num_iters = num_iters
        self.init_random = init_random
        self.candidates = candidates
        self.ell = ell
        self.noise = noise
        self.seed = seed

    def _search(self, profiles, fleet, job):
        T, L = len(fleet), len(profiles)
        rng = random.Random(self.seed)
        cache = CostCache(profiles, fleet, job)

        X: list[tuple[int, ...]] = []
        y: list[float] = []

        def observe(plan):
            c = cache.soft(plan)  # graded infeasibility (see CostCache)
            X.append(plan)
            y.append(math.log10(c + 1.0))  # log costs: GP-friendlier scale

        init = [tuple(rng.randrange(T) for _ in range(L))
                for _ in range(self.init_random)]
        cache.batch_soft(init)  # score the whole warm-up set in one pass
        for plan in init:
            observe(plan)

        for _ in range(self.num_iters - self.init_random):
            Xa = np.array(X, dtype=np.int64)
            ya = np.array(y)
            mu0, sd0 = ya.mean(), ya.std() + 1e-9
            yn = (ya - mu0) / sd0
            K = _hamming_kernel(Xa, Xa, self.ell) + self.noise * np.eye(len(X))
            Lc = np.linalg.cholesky(K)
            alpha = np.linalg.solve(Lc.T, np.linalg.solve(Lc, yn))

            cands = np.array(
                [[rng.randrange(T) for _ in range(L)] for _ in range(self.candidates)],
                dtype=np.int64,
            )
            Ks = _hamming_kernel(cands, Xa, self.ell)           # (c, n)
            mu = Ks @ alpha
            v = np.linalg.solve(Lc, Ks.T)                        # (n, c)
            var = np.clip(1.0 - (v**2).sum(0), 1e-12, None)
            sd = np.sqrt(var)
            best = yn.min()
            z = (best - mu) / sd
            # expected improvement (minimization)
            ei = sd * (z * _ncdf(z) + _npdf(z))
            pick = tuple(int(g) for g in cands[int(np.argmax(ei))])
            observe(pick)

        from repro_torch.core.plan import SchedulingPlan

        best_plan, _ = cache.best()
        return SchedulingPlan(best_plan), cache.evaluations, {}


def _npdf(z):
    return np.exp(-0.5 * z * z) / math.sqrt(2 * math.pi)


def _ncdf(z):
    from math import erf
    return 0.5 * (1.0 + np.vectorize(erf)(z / math.sqrt(2)))
