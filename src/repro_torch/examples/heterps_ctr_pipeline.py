"""End-to-end HeterPS example: CTR model with the full distributed stack.

This is the paper's own workload (§6): a CTR model with a huge sparse
embedding feeding a dense tower, trained on a streaming synthetic click
log with:

* RL-LSTM scheduling of the layer→resource-type plan (the fused search
  on the device),
* a **sharded parameter server** (``repro_torch.ps``) holding the
  embedding table across 4 PS shards in host memory — the async
  ``PSClient`` double-buffers pulls/pushes around the compute (while
  step *i* computes, batch *i+1*'s rows are pulled and step *i−1*'s row
  grads pushed),
* GPipe-style pipeline parallelism over the dense-tower stages on a
  ``stage`` axis of a torch ``DeviceMesh`` (point-to-point sends between
  neighbouring ranks).  One process makes a 1-wide stage mesh, and then,
  as in the reference, the pipeline runs only the first of the 4
  stacked stages (its 2 layers: each rank takes its own stage's slice).
  Launch one process per stage to run the real 4-stage pipeline — NCCL
  on one GPU each, or gloo on the CPU::

    PYTHONPATH=src torchrun --nproc-per-node 4 \\
        -m repro_torch.examples.heterps_ctr_pipeline --device cpu

  The mesh takes ``min(4, WORLD_SIZE)`` stages; every rank runs the same
  data and its own PS, and only rank 0 prints,
* the data-management access monitor deciding hot/warm/cold row tiers
  and the ``TierPlacer`` re-pinning them every 50 steps: from the first
  re-pin on, pulls that find the hot cache gather from it on the device
  (on a CUDA device through the embedding-bag kernel, bag 1),
* prefetching input pipeline, per-shard pull/push telemetry.

Trains ~65M parameters for a few hundred steps.  The 256 MB table is
drawn by ``torch.randn`` on the host and shipped to the shards; the
tower and the hot-row cache live on the device.

Run:  PYTHONPATH=src python -m repro_torch.examples.heterps_ctr_pipeline
      [--steps 300] [--lr 0.05] [--chaos] [--device cpu]

The PS-focused slice of this stack (without the pipeline) also runs via
the launcher's ``--sparse-ps`` mode, which fronts the *elastic*
multi-process fleet:

  PYTHONPATH=src python -m repro_torch.launch.train --sparse-ps \\
      --ps-transport multiproc --ps-optimizer adagrad \\
      --ps-event 100:join --ps-event 200:kill:0

**Checkpoint/restore walkthrough** (``--chaos``): trains the CTR model
over the elastic fleet with unified checkpoints (PS slabs + optimizer
state + tower + data cursor, published atomically behind a ``LATEST``
pointer) every 5 steps, while a seeded fault schedule crashes **both**
replicas of every bucket inside one step.  The trainer restores the
newest checkpoint, rewinds the deterministic click stream to its cursor,
replays, and finishes with losses bit-equal to a calm run — checked at
the end.  The launcher exposes the same machinery::

  PYTHONPATH=src python -m repro_torch.launch.train --sparse-ps \\
      --steps 60 --ps-shards 3 --ps-optimizer adagrad \\
      --ckpt-dir /tmp/ctr-ckpt --ckpt-every 10 \\
      --ps-fault 'crash,op=grad,shard=0,after=400,times=1;'\\
  'crash,op=grad,shard=1,after=400,times=1'
"""

from __future__ import annotations

import argparse
import itertools
import os
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import TrainingJob, default_fleet, paper_model_profiles
from repro_torch.core.schedulers import RLScheduler
from repro_torch.data import PrefetchLoader
from repro_torch.device import resolve_device
from repro_torch.examples import example_parser
from repro_torch.launch.mesh import PG_TIMEOUT, close_process_group
from repro_torch.parallel.pipeline import (
    make_stage_mesh, pipeline_loss, stack_stage_params,
)
from repro_torch.ps import (
    CTRConfig, PSClient, TierPlacer, click_stream, make_table,
    train_ctr_elastic,
)
from repro_torch.tree import tree_leaves, tree_map

VOCAB = 2_000_000
EMB_DIM = 32
SLOTS = 26            # criteo-style sparse slots
TOWER_D = 256
N_STAGES = 4
LAYERS_PER_STAGE = 2
MICRO = 8
MB = 32               # examples per microbatch
PS_SHARDS = 4
REPIN_EVERY = 50
RL_ROUNDS = 40
#: the --chaos walkthrough's smaller model
CHAOS_CFG = CTRConfig(vocab=50_000, emb_dim=16, slots=SLOTS, batch=128,
                      seed=0)
CHAOS_SCHEDULE = ("crash,op=grad,shard=0,after=400,times=1;"
                  "crash,op=grad,shard=1,after=400,times=1")


def stream_cfg() -> CTRConfig:
    """The shared synthetic click log (zipf-ish ids, planted logistic
    structure) at this example's pipeline batch geometry."""
    return CTRConfig(vocab=VOCAB, emb_dim=EMB_DIM, slots=SLOTS,
                     batch=MICRO * MB, seed=0)


# --- the model --------------------------------------------------------------

def init_weights() -> dict:
    """The dense tower as NumPy: ``in_proj`` (SLOTS·EMB_DIM, TOWER_D),
    ``stage_list`` (N_STAGES stages of LAYERS_PER_STAGE residual layers
    ``{"w", "b"}``) and ``head_w`` (TOWER_D,), weights ``N(0, 1/in)``
    from a ``torch.Generator`` seeded by 1 (the table takes the stream's
    seed, 0), biases zero."""
    g = torch.Generator().manual_seed(1)

    def normal(*shape):
        return (torch.randn(shape, generator=g) * shape[0]**-0.5).numpy()

    d_in = SLOTS * EMB_DIM
    return {
        "in_proj": normal(d_in, TOWER_D),
        "stage_list": [{"layers": [
            {"w": normal(TOWER_D, TOWER_D),
             "b": np.zeros((TOWER_D,), np.float32)}
            for _ in range(LAYERS_PER_STAGE)]} for _ in range(N_STAGES)],
        "head_w": normal(TOWER_D),
    }


def tower_from_numpy(weights: dict, *, device) -> dict:
    """The dense tower from NumPy ``weights`` (``in_proj``, ``stage_list``
    and ``head_w``, as :func:`init_weights` gives them): float32 tensors
    on ``device`` that require grad — ``in_proj``, ``stage_params`` (the
    stages stacked on a leading axis by :func:`stack_stage_params`) and
    ``head_w``."""
    dev = resolve_device(device)

    def tensor(a):
        return torch.tensor(np.asarray(a), dtype=torch.float32, device=dev)

    def param(t):
        return t.requires_grad_()

    stacked = stack_stage_params([tree_map(tensor, stage)
                                  for stage in weights["stage_list"]])
    return {"in_proj": param(tensor(weights["in_proj"])),
            "stage_params": tree_map(param, stacked),
            "head_w": param(tensor(weights["head_w"]))}


def weights_from_numpy(weights: dict, *, device, dense=None) -> dict:
    """The whole model from NumPy: e.g. the reference's initial
    ``in_proj``, ``stage_list`` and ``head_w`` as ``weights`` (the tower,
    :func:`tower_from_numpy`) and its table's ``to_dense()`` as ``dense``
    (the sharded ``table`` of :func:`make_table`, with the access monitor
    and telemetry attached; drawn from the stream's seed when ``dense``
    is None)."""
    return {**tower_from_numpy(weights, device=device),
            "table": make_table(stream_cfg(), PS_SHARDS,
                                device=resolve_device(device), dense=dense)}


def stage_fn(p, x):
    """One stage: LAYERS_PER_STAGE residual tanh layers."""
    h = x
    for layer in p["layers"]:
        h = h + torch.tanh(h @ layer["w"] + layer["b"])
    return h


def bce(logit, y):
    """The reference's numerically stable binary cross-entropy."""
    return torch.mean(torch.clamp(logit, min=0) - logit * y
                      + torch.log1p(torch.exp(-torch.abs(logit))))


def tower_loss(emb, in_proj, stage_params, head_w, labels, mesh):
    """The pipelined loss: ``emb`` enters as the *pulled* PS activation
    ``(MICRO·MB, SLOTS, EMB_DIM)``, so its gradient is exactly the
    per-row push payload."""
    x = emb.reshape(MICRO, MB, SLOTS * EMB_DIM) @ in_proj

    def head_loss(h, y):
        return bce(h @ head_w, y)

    return pipeline_loss(stage_fn, head_loss, stage_params, x,
                         labels.reshape(MICRO, MB), mesh)


def dense_params(model: dict) -> list[torch.Tensor]:
    """``in_proj``, every stacked stage leaf and ``head_w``, in the order
    :func:`tower_loss`'s gradients are taken."""
    return [model["in_proj"], *tree_leaves(model["stage_params"]),
            model["head_w"]]


# --- the run ----------------------------------------------------------------

def _stage_mesh(dev: torch.device):
    """The ``stage`` mesh: ``min(N_STAGES, WORLD_SIZE)`` ranks (a launcher
    such as torchrun sets ``WORLD_SIZE``; one process otherwise).  Returns
    the mesh and whether this call made the process group."""
    backend = "nccl" if dev.type == "cuda" else "gloo"
    made = not dist.is_initialized()
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if made and world > 1:
        dist.init_process_group(backend, timeout=PG_TIMEOUT)
    try:
        mesh = make_stage_mesh(min(N_STAGES, world), device_type=dev.type,
                               backend=backend)
    except BaseException:
        if made:
            close_process_group()
        raise
    return mesh, made


def _device(name) -> torch.device:
    """``name`` resolved (None: ``cuda``); under a launcher, CUDA rank r
    takes GPU ``LOCAL_RANK``."""
    dev = resolve_device(name)
    if dev.type == "cuda" and dev.index is None and "LOCAL_RANK" in os.environ:
        dev = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
        torch.cuda.set_device(dev)
    return dev


def train_pipeline(*, steps: int = 300, lr: float = 0.05, device=None,
                   weights: dict | None = None, dense=None) -> dict:
    """Schedule, build and train; prints the reference's lines and returns
    their numbers.  ``weights`` / ``dense`` (see
    :func:`weights_from_numpy`) replace :func:`init_weights` and the
    seeded table."""
    dev = _device(device)
    rank = int(os.environ.get("RANK", "0"))
    say = print if rank == 0 else (lambda *a, **k: None)

    # --- 1. schedule the CTR model with the RL scheduler ---------------
    fleet = default_fleet()
    job = TrainingJob()
    profiles = paper_model_profiles("CTRDNN", fleet)
    res = RLScheduler(rounds=RL_ROUNDS, seed=0, device=dev).schedule(
        profiles, fleet, job)
    plan = "".join(map(str, res.plan.assignment))
    say(f"RL-LSTM plan {plan} "
        f"cost {res.cost:.2f} USD, provisioning k={res.prov.k} "
        f"(embedding stage on {fleet[res.plan.assignment[0]].name})")

    # --- 2. build the model: sharded-PS embedding + pipelined tower ----
    model = weights_from_numpy(init_weights() if weights is None
                               else weights, device=dev, dense=dense)
    table = model["table"]
    try:
        out = _train(model, steps=steps, lr=lr, dev=dev, say=say)
    finally:
        table.close()
    return {"plan": plan, "plan_cost": res.cost, "k": list(res.prov.k),
            **out, "device": str(dev)}


def _train(model: dict, *, steps: int, lr: float, dev, say) -> dict:
    """The training loop over ``model``'s table and tower, then the
    report's lines."""
    table = model["table"]
    placer = TierPlacer(table, table.monitor, interval=REPIN_EVERY)
    params = dense_params(model)
    n_params = VOCAB * EMB_DIM + sum(p.numel() for p in params)
    client = loader = None
    mesh, made_group = _stage_mesh(dev)
    try:
        n_mesh = mesh.size(0)
        say(f"model: {n_params/1e6:.1f}M params, {N_STAGES}-stage pipeline "
            f"({n_mesh} pipeline devices), {MICRO} microbatches, "
            f"embedding on {PS_SHARDS} PS shards")

        # --- 3. train with prefetch + async sharded-PS pull/push -------
        loader = PrefetchLoader(
            itertools.islice(click_stream(stream_cfg()), steps), depth=2)
        client = PSClient(table, loader, ids_key="ids", depth=2)
        losses = []
        t0 = time.time()
        for step, (b, emb) in enumerate(client):
            labels = torch.from_numpy(b["label"]).to(dev)
            emb = emb.requires_grad_()
            loss = tower_loss(emb, model["in_proj"], model["stage_params"],
                              model["head_w"], labels, mesh)
            g_emb, *grads = torch.autograd.grad(loss, [emb, *params])
            # PS push (async): only touched rows move; sparse rows get a
            # higher learning rate (few updates per row)
            client.push(b["ids"], g_emb, lr=10.0 * lr)
            with torch.no_grad():
                for p, g in zip(params, grads):
                    p.sub_(lr * g)
            placer.step(step)
            losses.append(loss.item())
            if step % 50 == 0 or step == steps - 1:
                say(f"step {step:4d} logloss {losses[-1]:.4f} "
                    f"({(time.time()-t0)/(step+1):.3f}s/step)", flush=True)
        seconds = time.time() - t0
    finally:
        if client is not None:
            client.close()
        if loader is not None:
            loader.close()
        if made_group:
            close_process_group()

    first, last = losses[0], losses[-1]
    stats = table.monitor.stats()
    say(f"\nlogloss {first:.4f} → {last:.4f} "
        f"({'decreased' if last < first else 'did not decrease'})")
    say(f"tier monitor: {stats['device_rows']} hot rows → HBM, "
        f"{stats['host_rows']} warm → host, {stats['disk_rows']} cold → SSD "
        f"(of {VOCAB:,}; {placer.repins} re-pins)")
    tel = table.telemetry.totals()
    say(f"PS traffic: pulled {tel['pull']['bytes']/1e6:.1f} MB "
        f"@ {tel['pull']['bandwidth']/1e6:.1f} MB/s, pushed "
        f"{tel['push']['bytes']/1e6:.1f} MB "
        f"@ {tel['push']['bandwidth']/1e6:.1f} MB/s "
        f"(hot-tier pull fraction {tel['pull']['hot_fraction']:.0%})")
    shards = table.telemetry.shard_report()
    for r in shards:
        say(f"  shard {r['shard']}: pull {r['pull_rows']} rows "
            f"{r['pull_bytes']/1e6:.1f} MB, push {r['push_rows']} rows "
            f"{r['push_bytes']/1e6:.1f} MB")
    return {
        "params": n_params, "pipeline_devices": n_mesh,
        "steps": len(losses), "losses": losses, "first_loss": first,
        "last_loss": last, "s_per_step": seconds / max(len(losses), 1),
        "tiers": {k: stats[k] for k in ("device_rows", "host_rows",
                                        "disk_rows")},
        "repins": placer.repins, "hot_pulls": table.hot_pulls,
        "pull_bytes": tel["pull"]["bytes"], "push_bytes": tel["push"]["bytes"],
        "hot_fraction": tel["pull"]["hot_fraction"],
        "shards": [{k: r[k] for k in ("shard", "pull_rows", "pull_bytes",
                                      "push_rows", "push_bytes")}
                   for r in shards],
    }


def chaos_demo(steps: int, *, device=None) -> dict:
    """Kill both replicas mid-run; restore the unified checkpoint and
    replay to the calm run's exact loss trajectory."""
    dev = resolve_device(device)
    kw = dict(steps=steps, num_shards=3, optimizer="adagrad", mode="sync",
              device=dev)
    print(f"calm run: {steps} steps, 3 shards, PS-hosted adagrad")
    calm = train_ctr_elastic(CHAOS_CFG, **kw)
    with tempfile.TemporaryDirectory(prefix="ctr-chaos-ckpt-") as d:
        print("chaos run: checkpoint every 5 steps, then crash both "
              "replicas of every bucket inside one step")
        r = train_ctr_elastic(CHAOS_CFG, **kw, ckpt_dir=d, ckpt_every=5,
                              fault_schedule=CHAOS_SCHEDULE, fault_seed=0)
    for e in r["events"]:
        if e["kind"] in ("detected", "restore"):
            print(f"  event: {e}")
    drift = max(abs(a - b) for a, b in zip(calm["losses"], r["losses"]))
    crashes = sum(i["kind"] == "crash" for i in r["injections"])
    checkpoints = [s for s, _ in r["checkpoints"]]
    print(f"crashes injected: {crashes}, restores: {r['restores']}, "
          f"checkpoints: {checkpoints}")
    print(f"max |loss drift| vs calm run: {drift:.2e} "
          f"({'bit-exact' if drift == 0.0 else 'DRIFTED'})")
    return {"steps": steps, "drift": drift, "crashes": crashes,
            "restores": r["restores"], "checkpoints": checkpoints,
            "calm_losses": calm["losses"], "chaos_losses": r["losses"],
            "events": [e["kind"] for e in r["events"]]}


def build_parser() -> argparse.ArgumentParser:
    ap = example_parser(__doc__)
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--chaos", action="store_true",
                    help="run the kill-both-replicas checkpoint/restore "
                         "walkthrough instead of the pipeline")
    return ap


def main(argv: list[str] | None = None) -> dict:
    args = build_parser().parse_args(argv)
    if args.chaos:
        return chaos_demo(min(args.steps, 40), device=args.device)
    return train_pipeline(steps=args.steps, lr=args.lr, device=args.device)


if __name__ == "__main__":
    main()
