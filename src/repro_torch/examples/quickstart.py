"""Quickstart: the full HeterPS flow on the paper's CTRDNN model.

1. Profile the model's layers (OCT/ODT per resource type).
2. Schedule layers to resource types with the RL-LSTM scheduler
   (REINFORCE, Algorithm 1; the fused search runs on the device) and
   compare with baselines.
3. Provision replica counts per stage (load balancing + Newton, §5.1).
4. Report throughput / monetary cost from the cost model (§4.1).
5. Train a reduced assigned architecture end-to-end for a few steps
   (on a CUDA device through the flash attention kernels, forward and
   backward).

Run:  PYTHONPATH=src python -m repro_torch.examples.quickstart
      [--device cpu]
"""

from __future__ import annotations

import argparse

from repro_torch.core import (
    TrainingJob, build_stages, default_fleet, paper_model_profiles,
    pipeline_throughput,
)
from repro_torch.core.schedulers import (
    GreedyScheduler, HeuristicScheduler, RLScheduler,
)
from repro_torch.device import resolve_device
from repro_torch.examples import example_parser

MODEL = "CTRDNN"
RL_ROUNDS = 60
TRAIN_ARCH = "llama3.2-1b"
TRAIN_STEPS = 20
TRAIN_BATCH = 8
TRAIN_SEQ = 64


def build_parser() -> argparse.ArgumentParser:
    return example_parser(__doc__)


def main(argv: list[str] | None = None) -> dict:
    args = build_parser().parse_args(argv)
    dev = resolve_device(args.device)
    fleet = default_fleet()
    job = TrainingJob()
    profiles = paper_model_profiles(MODEL, fleet)
    print(f"{MODEL}: {len(profiles)} layers; fleet: "
          f"{[r.name for r in fleet]}; throughput limit "
          f"{job.throughput_limit:,.0f} ex/s\n")

    print(f"{'method':12s} {'cost(USD)':>12s} {'time(s)':>9s}  plan")
    results = {}
    for sched in (RLScheduler(rounds=RL_ROUNDS, seed=0, device=dev),
                  GreedyScheduler(), HeuristicScheduler()):
        r = sched.schedule(profiles, fleet, job)
        results[sched.name] = r
        print(f"{sched.name:12s} {r.cost:12.3f} {r.wall_time_s:9.2f}  "
              f"{''.join(str(a) for a in r.plan.assignment)}")

    best = results["RL-LSTM"]
    stages = build_stages(best.plan, profiles, fleet)
    print(f"\nRL-LSTM plan → {len(stages)} stages; provisioning "
          f"k={best.prov.k} (+{best.prov.ps_cores} PS cores)")
    tp = pipeline_throughput(stages, best.prov, job.batch_size)
    print(f"estimated throughput {tp:,.0f} ex/s "
          f"(limit {job.throughput_limit:,.0f}) — constraint "
          f"{'satisfied' if tp >= job.throughput_limit else 'VIOLATED'}")

    print(f"\n--- training a reduced assigned arch for {TRAIN_STEPS} "
          f"steps ---")
    from repro_torch.launch.train import train

    summary = train(TRAIN_ARCH, reduced=True, steps=TRAIN_STEPS,
                    batch=TRAIN_BATCH, seq=TRAIN_SEQ, log_every=5,
                    device=dev)
    print(f"loss {summary['first_loss']:.3f} → {summary['last_loss']:.3f} "
          f"({'decreased' if summary['loss_decreased'] else 'did not decrease'})")
    return {
        "layers": len(profiles),
        "schedulers": {name: {"cost": r.cost, "wall_time_s": r.wall_time_s,
                              "plan": list(r.plan.assignment),
                              "rounds_per_s": r.extra.get("rounds_per_s")}
                       for name, r in results.items()},
        "stages": len(stages), "k": list(best.prov.k),
        "ps_cores": best.prov.ps_cores, "throughput": tp,
        "throughput_limit": job.throughput_limit,
        "train": {k: summary[k] for k in (
            "first_loss", "last_loss", "loss_decreased", "steps",
            "seconds")},
    }


if __name__ == "__main__":
    main()
