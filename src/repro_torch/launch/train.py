"""Training launcher (port of ``repro.launch.train``).

Trains an arch end to end on synthetic Zipfian tokens: prefetch,
microbatched AdamW steps through ``models.decoder.loss_fn`` (flash
attention and, for MoE archs, the dispatch/combine kernels, forward and
backward, on a CUDA device), checkpointing and metrics.

  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
      --steps 5 --batch 8 --seq 32
  PYTHONPATH=src python -m repro_torch.launch.train --full --device cuda \\
      --steps 3 --batch 8 --seq 2048 --microbatch 4

``--sparse-ps`` switches to the sparse path: the CTR model trained over
the sharded parameter server (``repro_torch.ps``), the tower and the
hot-row cache on the device, the shards in host memory, with async
double-buffered pull/push overlap and tier-aware row placement:

  PYTHONPATH=src python -m repro_torch.launch.train --sparse-ps \\
      --steps 200 --ps-shards 4 --device cuda

A PS-hosted optimizer (``--ps-optimizer sgd|adagrad|adam``), scripted
fleet events (``--ps-event``), chaos (``--ps-fault``, ``--ckpt-dir`` +
``--ckpt-every``) or ``--replan`` train over the **elastic fleet**
instead (``repro_torch.ps.elastic``; chaos forces sync mode), e.g.:

  PYTHONPATH=src python -m repro_torch.launch.train --sparse-ps \\
      --steps 30 --ps-transport multiproc --ps-optimizer adagrad \\
      --ps-event 10:join --ps-event 20:kill:0
  PYTHONPATH=src python -m repro_torch.launch.train --sparse-ps --replan \\
      --replan-window-steps 5 --ps-event 20:kill:0
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

    # the audio and vision archs train on stub frontend embeddings
    ctx_len = cfg.encoder.frames if cfg.encoder else cfg.cross_kv_len
    ds = SyntheticTokenDataset(cfg.vocab, batch, seq, seed=seed,
                               context_len=ctx_len, d_model=cfg.d_model)
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
            tbatch = {k: torch.from_numpy(v).to(dev)
                      for k, v in batch_np.items()}
            # the step records its own ``train.step`` span
            params, opt_state, metrics = step_fn(params, opt_state, tbatch)
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


def train_sparse_ps(*, steps: int, batch: int | None = None,
                    lr: float | None = None, num_shards: int = 4,
                    sync: bool = False, partition: str = "mod",
                    repin_interval: int = 50, log_every: int = 10,
                    transport: str | None = None, device=None,
                    optimizer: str = "none",
                    events: list[tuple[int, str, int | None]] | None = None,
                    staleness_bound: int = 8,
                    ckpt_dir: str | None = None, ckpt_every: int = 0,
                    fault_schedule: str | None = None,
                    fault_seed: int = 0, replan=None) -> dict:
    """The ``--sparse-ps`` path: the CTR model over the sharded PS
    (``repro_torch.ps``) on ``device`` (default ``cuda``) — async
    double-buffered pull/push unless ``sync``.  ``batch``/``lr`` default
    to the CTR workload's own values; ``transport`` picks the PS backend
    (``inproc`` | ``multiproc``).

    ``optimizer="none"`` (default) keeps the static :class:`ShardedTable`
    with client-side SGD and the hot cache; any other value
    (``sgd``/``adagrad``/``adam``) trains over the **elastic fleet** with
    the optimizer hosted on the PS shards, and ``events`` (parsed
    ``(step, action, shard)`` tuples, see :func:`_parse_ps_events`)
    script fleet changes mid-run (:func:`repro_torch.ps.workload.
    train_ctr_elastic`).

    ``ckpt_dir`` + ``ckpt_every`` arm crash-consistent unified
    checkpoints (fleet slabs + optimizer state + tower + data cursor);
    after a correlated primary+backup loss the run restores the newest
    checkpoint and replays to a bit-exact trajectory.  ``fault_schedule``
    (``repro_torch.ps.faults.parse_schedule`` syntax, seeded by
    ``fault_seed``) injects deterministic chaos.  Both force the elastic
    fleet and sync mode.

    ``replan`` (a :class:`repro_torch.core.replan.ReplanConfig`) arms the
    reactive re-planning controller (``ctr_replan_factory``, its search
    on ``device``): live PS telemetry + fleet health are windowed into
    interval rates, drift triggers a warm-started re-plan, and the
    decisions land in the summary under ``"replan"``.  Forces the
    elastic fleet (the controller consumes fleet health).
    """
    import dataclasses

    from repro_torch.ps.workload import (
        CTRConfig, train_ctr_elastic, train_ctr_ps,
    )

    overrides = {k: v for k, v in (("batch", batch), ("lr", lr))
                 if v is not None}
    cfg = dataclasses.replace(CTRConfig(), **overrides)
    chaos = bool((ckpt_dir and ckpt_every) or fault_schedule)
    if optimizer != "none" or events or chaos or replan is not None:
        factory = None
        if replan is not None:
            from repro_torch.core.replan import ctr_replan_factory

            factory = ctr_replan_factory(replan, device=device)
        return train_ctr_elastic(
            cfg, steps=steps, num_shards=num_shards,
            optimizer=optimizer if optimizer != "none" else "sgd",
            transport=transport,
            mode="sync" if sync or chaos else "async",
            events=events, staleness_bound=staleness_bound,
            fault_schedule=fault_schedule, fault_seed=fault_seed,
            ckpt_dir=ckpt_dir, ckpt_every=ckpt_every, replan=factory,
            log_every=log_every, device=device)
    return train_ctr_ps(cfg, steps=steps, num_shards=num_shards,
                        mode="sync" if sync else "async",
                        partition=partition, repin_interval=repin_interval,
                        log_every=log_every, transport=transport,
                        device=device)


def _parse_ps_events(specs: list[str]) -> list[tuple[int, str, int | None]]:
    """``STEP:ACTION[:SHARD]`` → scripted fleet events, e.g.
    ``40:join`` / ``80:kill:0`` / ``120:leave:1``."""
    events = []
    for spec in specs:
        parts = spec.split(":")
        if len(parts) not in (2, 3) or parts[1] not in ("join", "kill",
                                                        "leave"):
            raise SystemExit(f"bad --ps-event {spec!r} "
                             f"(want STEP:join|kill|leave[:SHARD])")
        events.append((int(parts[0]), parts[1],
                       int(parts[2]) if len(parts) == 3 else None))
    return events


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
    # batch/lr defaults depend on the path (dense: 8 / 3e-4; sparse-ps:
    # the CTR workload's 256 / 0.05), so resolve after parsing
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=None)
    ap.add_argument("--microbatch", type=int, default=None)
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--sparse-ps", action="store_true",
                    help="train the CTR workload over the sharded "
                         "parameter server instead of a dense arch")
    ap.add_argument("--ps-shards", type=int, default=4)
    ap.add_argument("--ps-sync", action="store_true",
                    help="synchronous pull→compute→push (no overlap)")
    ap.add_argument("--ps-partition", choices=("mod", "block"), default="mod")
    ap.add_argument("--ps-transport", choices=("inproc", "multiproc"),
                    default=None,
                    help="PS backend: in-process queues (default) or one "
                         "worker process per shard")
    ap.add_argument("--ps-optimizer",
                    choices=("none", "sgd", "adagrad", "adam"),
                    default="none",
                    help="PS-hosted optimizer; any value but 'none' trains "
                         "over the elastic fleet")
    ap.add_argument("--ps-event", action="append", default=[],
                    metavar="STEP:ACTION[:SHARD]",
                    help="scripted elastic fleet event, repeatable — e.g. "
                         "'40:join', '80:kill:0', '120:leave:1'")
    ap.add_argument("--ps-staleness-bound", type=int, default=8,
                    help="max updates a pull may miss during live "
                         "migration (0 = full dual-write)")
    ap.add_argument("--ckpt-dir", default=None,
                    help="unified fleet checkpoints (PS slabs + optimizer "
                         "state + tower + data cursor) under this "
                         "directory; restores after correlated "
                         "primary+backup loss replay bit-exactly")
    ap.add_argument("--ckpt-every", type=int, default=0,
                    help="checkpoint cadence in steps (0 = off)")
    ap.add_argument("--ps-fault", default=None, metavar="RULE[;RULE...]",
                    help="deterministic fault schedule, e.g. "
                         "'drop_reply,op=grad,after=100,times=2;"
                         "crash,shard=0,after=400,times=1' "
                         "(see repro_torch.ps.faults.parse_schedule)")
    ap.add_argument("--ps-fault-seed", type=int, default=0)
    ap.add_argument("--replan", action="store_true",
                    help="arm the reactive re-planning controller: window "
                         "PS telemetry + fleet health into interval rates, "
                         "re-run the warm-started RL search on drift "
                         "(forces the elastic fleet)")
    ap.add_argument("--replan-window-steps", type=int, default=25,
                    help="steps per telemetry window")
    ap.add_argument("--replan-bw-tol", type=float, default=0.5,
                    help="relative bandwidth deviation that counts as drift")
    ap.add_argument("--replan-margin", type=float, default=0.05,
                    help="fractional cost improvement required to switch "
                         "plans")
    ap.add_argument("--replan-cooldown", type=int, default=3,
                    help="windows to sit out after a replan consideration")
    ap.add_argument("--obs-dir", default=None,
                    help="enable observability and write trace.json + "
                         "metrics.jsonl to this directory")
    return ap


def main(argv: list[str] | None = None) -> None:
    args = build_parser().parse_args(argv)
    if args.obs_dir:
        # before any transport spawn, so shard workers inherit REPRO_OBS
        obs.configure(run_dir=args.obs_dir)
    if args.sparse_ps:
        replan_cfg = None
        if args.replan:
            from repro_torch.core.replan import ReplanConfig

            replan_cfg = ReplanConfig(
                window_steps=args.replan_window_steps,
                bw_tolerance=args.replan_bw_tol,
                switch_margin=args.replan_margin,
                cooldown_windows=args.replan_cooldown)
        summary = train_sparse_ps(
            steps=args.steps, batch=args.batch, lr=args.lr,
            num_shards=args.ps_shards, sync=args.ps_sync,
            partition=args.ps_partition, transport=args.ps_transport,
            device=args.device, optimizer=args.ps_optimizer,
            events=_parse_ps_events(args.ps_event),
            staleness_bound=args.ps_staleness_bound,
            ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
            fault_schedule=args.ps_fault, fault_seed=args.ps_fault_seed,
            replan=replan_cfg)
        for key in ("step_times", "step_ts", "losses", "injections"):
            summary.pop(key, None)
    else:
        summary = train(args.arch, reduced=args.reduced, steps=args.steps,
                        batch=args.batch if args.batch is not None else 8,
                        seq=args.seq,
                        lr=args.lr if args.lr is not None else 3e-4,
                        microbatch=args.microbatch,
                        checkpoint_dir=args.checkpoint_dir,
                        device=args.device)
    if args.obs_dir:
        summary["obs"] = obs.flush()
    print(json.dumps(summary, indent=2))


if __name__ == "__main__":
    main()
