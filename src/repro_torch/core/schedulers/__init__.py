"""Scheduling methods: HeterPS RL-LSTM + the paper's §6.2 baselines (the
port of ``repro.core.schedulers``)."""

from repro_torch.core.schedulers.base import ScheduleResult, Scheduler
from repro_torch.core.schedulers.bayesian import BayesianScheduler
from repro_torch.core.schedulers.genetic import GeneticScheduler
from repro_torch.core.schedulers.rl import RLScheduler
from repro_torch.core.schedulers.static import (
    BruteForceScheduler,
    CPUOnlyScheduler,
    GPUOnlyScheduler,
    GreedyScheduler,
    HeuristicScheduler,
)

ALL_SCHEDULERS = {
    "RL-LSTM": lambda **kw: RLScheduler(cell="lstm", **kw),
    "RL-RNN": lambda **kw: RLScheduler(cell="rnn", **kw),
    "BO": BayesianScheduler,
    "Genetic": GeneticScheduler,
    "Greedy": GreedyScheduler,
    "CPU": CPUOnlyScheduler,
    "GPU": GPUOnlyScheduler,
    "Heuristic": HeuristicScheduler,
    "BF": BruteForceScheduler,
}

__all__ = [
    "Scheduler", "ScheduleResult", "RLScheduler", "BayesianScheduler",
    "GeneticScheduler", "BruteForceScheduler", "CPUOnlyScheduler",
    "GPUOnlyScheduler", "GreedyScheduler", "HeuristicScheduler",
    "ALL_SCHEDULERS",
]
