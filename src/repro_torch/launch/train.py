"""Training launcher (port of the dense half of ``repro.launch.train``).

Trains an arch end to end on synthetic Zipfian tokens: prefetch,
microbatched AdamW steps through ``models.decoder.loss_fn`` (flash
attention and, for MoE archs, the dispatch/combine kernels, forward and
backward, on a CUDA device), checkpointing and metrics.

  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
      --steps 5 --batch 8 --seq 32
  PYTHONPATH=src python -m repro_torch.launch.train --full --device cuda \\
      --steps 3 --batch 8 --seq 2048 --microbatch 4

The sparse parameter-server path (``--sparse-ps`` and its flags) waits
for the CTR/PS slice (ROADMAP.md queue 1 item 11).
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch import obs
from repro_torch.checkpoint import save_checkpoint
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.data import PrefetchLoader, SyntheticTokenDataset
from repro_torch.device import resolve_device
from repro_torch.launch.steps import init_train_state, make_train_step
from repro_torch.obs import trace as obs_trace
from repro_torch.tree import tree_leaves


def train(arch, *, reduced: bool = True, steps: int = 50, batch: int = 8,
          seq: int = 128, lr: float = 3e-4, microbatch: int | None = None,
          seed: int = 0, checkpoint_dir: str | None = None,
          log_every: int = 10, compute_dtype=torch.float32,
          device=None) -> dict:
    """Train ``arch`` (an arch id or an ``ArchConfig``) for ``steps``
    steps on ``device`` (default ``cuda``; ``"cpu"`` runs the plain
    PyTorch path).  Parameters come from ``seed`` through the port's own
    initializer, so losses are not the reference's number for number.
    Returns the reference's summary (arch, params, steps, first/last loss,
    ``loss_decreased`` by head/tail means, seconds) plus every step's
    ``losses`` and ``grad_norms`` and the ``devices`` that hold the
    parameters and optimizer state."""
    cfg = get_config(arch, reduced=reduced) if isinstance(arch, str) else arch
    dev = resolve_device(device)
    params, opt_state = init_train_state(cfg, seed=seed, device=dev)
    n_params = sum(t.numel() for t in tree_leaves(params))

    ds = SyntheticTokenDataset(cfg.vocab, batch, seq, seed=seed)
    loader = PrefetchLoader(ds, depth=2)
    step_fn = make_train_step(cfg, lr=lr, microbatch=microbatch,
                              compute_dtype=compute_dtype)

    losses, gnorms = [], []
    reg = obs.REGISTRY
    t0 = time.perf_counter()
    try:
        for i in range(steps):
            td = time.perf_counter()
            batch_np = next(loader)
            reg.histogram("train.data_s").record(time.perf_counter() - td)
            ts = time.perf_counter()
            with obs_trace.span("train.step", "train", step=i):
                tbatch = {k: torch.from_numpy(v).to(dev)
                          for k, v in batch_np.items()}
                params, opt_state, metrics = step_fn(params, opt_state,
                                                     tbatch)
                # float() syncs the step: the histogram sees its real time
                losses.append(float(metrics["loss"]))
            reg.histogram("train.step_s").record(time.perf_counter() - ts)
            gnorms.append(float(metrics["grad_norm"]))
            if log_every and (i % log_every == 0 or i == steps - 1):
                print(f"step {i:4d} loss {losses[-1]:.4f} "
                      f"gnorm {gnorms[-1]:.3f} "
                      f"({(time.perf_counter() - t0) / (i + 1):.2f}s/step)",
                      flush=True)
    finally:
        loader.close()
    if checkpoint_dir:
        save_checkpoint(checkpoint_dir, params=params, opt_state=opt_state,
                        step=steps, metadata={"arch": cfg.name})
        print(f"checkpoint -> {checkpoint_dir}")
    # head/tail means: a single-sample first-vs-last comparison is noise
    k = max(1, min(5, steps // 4))
    devices = {str(t.device)
               for t in tree_leaves(params) + tree_leaves(opt_state)}
    return {
        "arch": cfg.name, "params": n_params, "steps": steps,
        "first_loss": losses[0], "last_loss": losses[-1],
        "loss_decreased": float(np.mean(losses[-k:]))
        < float(np.mean(losses[:k])),
        "seconds": time.perf_counter() - t0,
        "losses": losses, "grad_norms": gnorms, "devices": sorted(devices),
    }


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="Train an arch of the PyTorch/CUDA port on synthetic "
                    "tokens (prints a JSON summary).")
    ap.add_argument("--arch", choices=ARCH_IDS, default="llama3.2-1b")
    ap.add_argument("--reduced", action="store_true", default=True,
                    help="the small config of the arch (the default)")
    ap.add_argument("--full", dest="reduced", action="store_false",
                    help="the full-width config")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; pass cpu for the "
                         "plain PyTorch path)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatch", type=int, default=None)
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--obs-dir", default=None,
                    help="enable observability and write trace.json + "
                         "metrics.jsonl to this directory")
    return ap


def main(argv: list[str] | None = None) -> None:
    args = build_parser().parse_args(argv)
    if args.obs_dir:
        obs.configure(run_dir=args.obs_dir)
    summary = train(args.arch, reduced=args.reduced, steps=args.steps,
                    batch=args.batch, seq=args.seq, lr=args.lr,
                    microbatch=args.microbatch,
                    checkpoint_dir=args.checkpoint_dir, device=args.device)
    if args.obs_dir:
        summary["obs"] = obs.flush()
    print(json.dumps(summary, indent=2))


if __name__ == "__main__":
    main()
