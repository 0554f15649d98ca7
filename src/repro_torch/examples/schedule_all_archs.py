"""Schedule the 10 assigned architectures with HeterPS (RL-LSTM vs
baselines) — the paper's technique applied beyond its own CTR models.

Each arch's layers are profiled analytically (FLOPs/bytes per layer →
OCT/ODT on each resource type) and scheduled to a heterogeneous fleet.
The RL-LSTM search runs fused on the device; the baselines and the
profiles are NumPy.

Run:  PYTHONPATH=src python -m repro_torch.examples.schedule_all_archs
      [--device cpu]
"""

from __future__ import annotations

import argparse

from repro_torch.configs import ARCH_IDS
from repro_torch.core import TrainingJob, make_fleet
from repro_torch.core.schedulers import (
    GreedyScheduler, HeuristicScheduler, RLScheduler,
)
from repro_torch.device import resolve_device
from repro_torch.examples import example_parser
from repro_torch.models.profile import profile_arch

ARCHS = ARCH_IDS
FLEET_TYPES = 4
RL_ROUNDS = 40
JOB = dict(batch_size=256, throughput_limit=2_000.0,
           num_examples=50_000_000)


def build_parser() -> argparse.ArgumentParser:
    return example_parser(__doc__)


def main(argv: list[str] | None = None) -> dict:
    args = build_parser().parse_args(argv)
    dev = resolve_device(args.device)
    fleet = make_fleet(FLEET_TYPES)
    job = TrainingJob(**JOB)
    print(f"fleet: {[r.name for r in fleet]}\n")
    print(f"{'arch':26s} {'RL-LSTM':>10s} {'Greedy':>10s} {'Heuristic':>10s}  stages")
    rows = {}
    for arch in ARCHS:
        profiles = profile_arch(arch, fleet)
        rl = RLScheduler(rounds=RL_ROUNDS, seed=0,
                         device=dev).schedule(profiles, fleet, job)
        gr = GreedyScheduler().schedule(profiles, fleet, job)
        he = HeuristicScheduler().schedule(profiles, fleet, job)
        n_stages = len(rl.plan.stage_boundaries())
        print(f"{arch:26s} {rl.cost:10.2f} {gr.cost:10.2f} {he.cost:10.2f}  "
              f"{n_stages}")
        rows[arch] = {
            "layers": len(profiles), "stages": n_stages,
            "rl_seconds": rl.wall_time_s,
            "rl_rounds_per_s": rl.extra.get("rounds_per_s"),
            **{f"{key}_{what}": value for key, r in (
                ("rl", rl), ("greedy", gr), ("heuristic", he))
               for what, value in (("cost", r.cost),
                                   ("plan", list(r.plan.assignment)))}}
    return {"fleet": [r.name for r in fleet], "archs": rows}


if __name__ == "__main__":
    main()
