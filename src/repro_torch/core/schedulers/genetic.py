"""Genetic-algorithm scheduling baseline (HeterPS §6.2, [3]; the port's
copy of ``repro.core.schedulers.genetic``)."""

from __future__ import annotations

import random

from repro_torch.core.schedulers.base import CostCache, Scheduler


class GeneticScheduler(Scheduler):
    name = "Genetic"

    def __init__(
        self,
        population: int = 32,
        generations: int = 40,
        mutation_rate: float = 0.08,
        elite: int = 2,
        seed: int = 0,
    ):
        self.population = population
        self.generations = generations
        self.mutation_rate = mutation_rate
        self.elite = elite
        self.seed = seed

    def _search(self, profiles, fleet, job):
        T, L = len(fleet), len(profiles)
        rng = random.Random(self.seed)
        cache = CostCache(profiles, fleet, job)

        pop = [tuple(rng.randrange(T) for _ in range(L)) for _ in range(self.population)]
        # seed with the homogeneous plans (guaranteed-structure anchors)
        pop[: min(T, len(pop))] = [(t,) * L for t in range(min(T, len(pop)))]

        def fitness(ind):
            return cache.soft(ind)  # graded infeasibility (see CostCache)

        for _ in range(self.generations):
            cache.batch_soft(pop)  # score the generation in one pass
            scored = sorted(pop, key=fitness)
            nxt = scored[: self.elite]
            while len(nxt) < self.population:
                # tournament selection
                a = min(rng.sample(scored, 3), key=fitness)
                b = min(rng.sample(scored, 3), key=fitness)
                # one-point crossover
                cut = rng.randrange(1, L) if L > 1 else 0
                child = a[:cut] + b[cut:]
                # mutation
                child = tuple(
                    rng.randrange(T) if rng.random() < self.mutation_rate else g
                    for g in child
                )
                nxt.append(child)
            pop = nxt

        from repro_torch.core.plan import SchedulingPlan

        best, _ = cache.best()
        return SchedulingPlan(best), cache.evaluations, {}
