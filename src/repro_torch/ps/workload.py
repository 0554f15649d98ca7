"""CTR-over-PS workload (HeterPS §6's sparse workload; port of
``repro.ps.workload``) — behind ``launch/train.py --sparse-ps``.

One step: pull the batch's embedding rows from the sharded PS onto the
device, run a dense tower on the concatenated slot embeddings there, push
the row gradients back.  :func:`train_ctr_ps` drives it either
*synchronously* (pull → compute → push, the baseline) or
*asynchronously* through :class:`~repro_torch.ps.client.PSClient`
(double-buffered overlap), with the tier placer re-pinning hot rows into
the device-side cache on a fixed cadence.

The tower is a dict of plain tensors in the reference's layout,
``{"w": [(in, out), …], "b": [(out,), …]}`` (``h @ w + b``), so the
reference's tower carries over leaf for leaf (:func:`tower_from_numpy`).

:func:`train_ctr_elastic` trains the same model over the **elastic**
fleet (:class:`~repro_torch.ps.elastic.ElasticPSFleet`: PS-hosted
optimizers, replicas, scripted join/leave/kill), with seeded fault
injection, unified fleet checkpoints with restore-and-replay, and an
optional re-planning controller observed every step.
"""

from __future__ import annotations

import dataclasses
import itertools
import time
from typing import Iterator

import numpy as np
import torch

from repro_torch.core.resources import CPU_CORE
from repro_torch.data import AccessMonitor, PrefetchLoader
from repro_torch.device import resolve_device
from repro_torch.ps.client import PSClient
from repro_torch.ps.elastic import ElasticPSFleet, PSUnrecoverable
from repro_torch.ps.faults import FaultInjector
from repro_torch.ps.placement import TierPlacer
from repro_torch.ps.sharding import ShardedTable
from repro_torch.ps.snapshot import FleetCheckpointer, load_fleet_checkpoint
from repro_torch.ps.telemetry import PSTelemetry
from repro_torch.ps.transport import make_transport


@dataclasses.dataclass(frozen=True)
class CTRConfig:
    """Criteo-style CTR model: 26 sparse slots → dense tower."""

    vocab: int = 200_000
    emb_dim: int = 16
    slots: int = 26
    tower: tuple[int, ...] = (512, 512, 256)
    batch: int = 256
    seed: int = 0
    lr: float = 0.05
    emb_lr_scale: float = 10.0   # sparse rows see few updates each → hotter lr


def click_stream(cfg: CTRConfig) -> Iterator[dict]:
    """Synthetic click log: zipf-ish sparse ids (hot head, long tail —
    drives the tier monitor) with a planted logistic structure so the
    logloss actually decreases.  NumPy, drawn as the reference draws it:
    the two packages see the same batches bit for bit."""
    rng = np.random.default_rng(cfg.seed)
    w_true = rng.standard_normal(cfg.slots) * 0.7
    while True:
        ids = (rng.pareto(1.2, (cfg.batch, cfg.slots)) * 1000).astype(
            np.int64) % cfg.vocab
        sig = (np.sin(ids % 97) * w_true).sum(-1)
        y = (sig + rng.standard_normal(cfg.batch) * 0.5 > 0)
        yield {"ids": ids.astype(np.int32),
               "label": y.astype(np.float32)}


def _tower_dims(cfg: CTRConfig) -> tuple[int, ...]:
    return (cfg.slots * cfg.emb_dim,) + tuple(cfg.tower) + (1,)


def init_tower(cfg: CTRConfig, *, device=None) -> dict:
    """The tower's parameters on ``device`` (default ``cuda``): weights
    ``N(0, 1/in)`` from a ``torch.Generator`` seeded by ``cfg.seed + 1``
    (the table takes ``cfg.seed``), biases zero."""
    dev = resolve_device(device)
    g = torch.Generator().manual_seed(cfg.seed + 1)
    pairs = list(itertools.pairwise(_tower_dims(cfg)))
    return {
        "w": [(torch.randn((a, b), generator=g) * a**-0.5).to(dev)
              for a, b in pairs],
        "b": [torch.zeros((b,), device=dev) for _, b in pairs],
    }


def tower_from_numpy(np_tower: dict, cfg: CTRConfig, *, device=None) -> dict:
    """The reference's tower pytree (``{"w": [...], "b": [...]}`` with
    numpy leaves, e.g. ``jax.tree.map(np.asarray, tower)``) as the port's
    float32 tensors on ``device`` (default ``cuda``).  Both keep weights
    as ``(in, out)``, so no leaf is transposed; shapes are checked
    against ``cfg``."""
    dev = resolve_device(device)
    pairs = list(itertools.pairwise(_tower_dims(cfg)))
    want = {"w": pairs, "b": [(b,) for _, b in pairs]}
    got = {k: [tuple(np.shape(a)) for a in np_tower[k]] for k in ("w", "b")}
    if got != want:
        raise ValueError(f"tower shapes {got} do not match the config's "
                         f"{want}")
    return {k: [torch.tensor(np.asarray(a), dtype=torch.float32, device=dev)
                for a in np_tower[k]] for k in ("w", "b")}


def make_step_fn(cfg: CTRConfig):
    """``(tower, emb_rows, labels) → (tower', emb_row_grads, loss)``.

    The embedding rows enter as a *pulled* activation ``(B, slots, D)``;
    differentiating w.r.t. them yields exactly the per-row gradients the
    PS push wants — the table itself never enters the step.  The loss is
    the reference's numerically stable BCE on the logits and the update
    its plain SGD, ``p - lr * g``."""

    def bce(logit, y):
        return torch.mean(torch.maximum(logit, torch.zeros_like(logit))
                          - logit * y
                          + torch.log1p(torch.exp(-torch.abs(logit))))

    def loss_fn(ws, bs, emb, labels):
        h = emb.reshape(emb.shape[0], cfg.slots * cfg.emb_dim)
        for i, (w, b) in enumerate(zip(ws, bs)):
            h = h @ w + b
            if i < len(ws) - 1:
                h = torch.tanh(h)
        return bce(h[:, 0], labels)

    def step(tower, emb, labels):
        ws = [w.detach().requires_grad_() for w in tower["w"]]
        bs = [b.detach().requires_grad_() for b in tower["b"]]
        emb = emb.detach().requires_grad_()
        with torch.enable_grad():
            loss = loss_fn(ws, bs, emb, labels)
            grads = torch.autograd.grad(loss, ws + bs + [emb])
        n = len(ws)
        with torch.no_grad():
            tower = {"w": [p - cfg.lr * g for p, g in zip(ws, grads[:n])],
                     "b": [p - cfg.lr * g
                           for p, g in zip(bs, grads[n:2 * n])]}
        return tower, grads[-1], loss.detach()

    return step


def make_table(cfg: CTRConfig, num_shards: int, *,
               partition: str = "mod", rpc_latency_s: float = 0.0,
               with_monitor: bool = True, transport=None, device=None,
               dense=None, impl: str = "auto") -> ShardedTable:
    """The CTR model's sharded table with an access monitor and
    telemetry: ``N(0, 1) * 0.05`` from a ``torch.Generator`` seeded by
    ``cfg.seed``, or ``dense`` (a ``(vocab, emb_dim)`` array or tensor)
    when given.  ``device`` and ``impl`` as :class:`ShardedTable`."""
    kw = dict(partition=partition,
              monitor=AccessMonitor(cfg.vocab) if with_monitor else None,
              telemetry=PSTelemetry(num_shards),
              rpc_latency_s=rpc_latency_s, transport=transport,
              device=device, impl=impl)
    if dense is not None:
        if tuple(np.shape(dense)) != (cfg.vocab, cfg.emb_dim):
            raise ValueError(f"dense table of shape {np.shape(dense)}, the "
                             f"config needs {(cfg.vocab, cfg.emb_dim)}")
        return ShardedTable.from_dense(dense, num_shards, **kw)
    return ShardedTable(cfg.vocab, cfg.emb_dim, num_shards, cfg.seed,
                        init_scale=0.05, **kw)


def make_fleet(cfg: CTRConfig, num_shards: int, *,
               optimizer: str = "sgd", transport=None,
               staleness_bound: int = 8, rpc_latency_s: float = 0.0,
               device=None, dense=None) -> ElasticPSFleet:
    """The CTR model's elastic fleet with telemetry: ``N(0, 1) * 0.05``
    from a ``torch.Generator`` seeded by ``cfg.seed``, or ``dense`` (a
    ``(vocab, emb_dim)`` array or tensor) when given.  ``device`` as
    :class:`ElasticPSFleet`."""
    kw = dict(num_shards=num_shards, optimizer=optimizer,
              transport=transport, telemetry=PSTelemetry(num_shards),
              staleness_bound=staleness_bound, rpc_latency_s=rpc_latency_s,
              device=device)
    if dense is not None:
        if tuple(np.shape(dense)) != (cfg.vocab, cfg.emb_dim):
            raise ValueError(f"dense table of shape {np.shape(dense)}, the "
                             f"config needs {(cfg.vocab, cfg.emb_dim)}")
        return ElasticPSFleet.from_dense(dense, **kw)
    return ElasticPSFleet(cfg.vocab, cfg.emb_dim, seed=cfg.seed,
                          init_scale=0.05, **kw)


def train_ctr_ps(cfg: CTRConfig | None = None, *, steps: int = 200,
                 num_shards: int = 4, mode: str = "async",
                 partition: str = "mod", rpc_latency_s: float = 0.0,
                 repin_interval: int = 50, depth: int = 2,
                 log_every: int = 0, transport=None, device=None,
                 table: ShardedTable | None = None,
                 tower: dict | None = None) -> dict:
    """Train the CTR model over the sharded PS, the tower on ``device``
    (default ``cuda``).

    ``mode="sync"``: pull → compute → push each step (the baseline the
    overlap benchmark compares against).  ``mode="async"``: the
    :class:`PSClient` double-buffers pulls and pushes around the compute.

    Seams: ``table`` (e.g. :func:`make_table` with ``dense=``) replaces
    the table this call would build — it must carry a monitor, its device
    is the run's, and the caller owns it (it is not closed here, so its
    final state can be read); ``tower`` (e.g. :func:`tower_from_numpy`)
    replaces :func:`init_tower`.  Returns the reference's summary plus
    every step's ``losses``, the pull/push seconds, ``hot_pulls`` (pulls
    that gathered from the hot cache) and the ``devices`` of the tower
    and the cache."""
    if mode not in ("sync", "async"):
        raise ValueError(f"mode must be sync|async, got {mode!r}")
    cfg = cfg or CTRConfig()
    own_table = table is None
    if own_table:
        table = make_table(cfg, num_shards, partition=partition,
                           rpc_latency_s=rpc_latency_s, transport=transport,
                           device=device)
    dev = table.device
    try:
        placer = TierPlacer(table, table.monitor, interval=repin_interval)
        step_fn = make_step_fn(cfg)
        tower = (init_tower(cfg, device=dev) if tower is None else
                 {k: [t.to(dev) for t in v] for k, v in tower.items()})
        emb_lr = cfg.lr * cfg.emb_lr_scale

        losses: list[float] = []
        times: list[float] = []
        ts: list[float] = []        # absolute per-step finish times (for
        t_start = time.perf_counter()  # steady-state rate measurement)

        def finish(i, t0, loss):
            placer.step(i)
            losses.append(float(loss))
            times.append(time.perf_counter() - t0)
            ts.append(time.perf_counter() - t_start)
            if log_every and i % log_every == 0:
                print(f"step {i:4d} logloss {losses[-1]:.4f} "
                      f"({times[-1] * 1e3:.1f} ms)", flush=True)

        if mode == "sync":
            stream = click_stream(cfg)
            for i in range(steps):
                t0 = time.perf_counter()
                b = next(stream)
                rows = table.pull(b["ids"])
                tower, g_emb, loss = step_fn(
                    tower, rows, torch.from_numpy(b["label"]).to(dev))
                table.push(b["ids"], g_emb, lr=emb_lr)
                finish(i, t0, loss)
        else:
            loader = PrefetchLoader(
                itertools.islice(click_stream(cfg), steps), depth=depth)
            client = PSClient(table, loader, ids_key="ids", depth=depth)
            try:
                for i, (b, rows) in enumerate(client):
                    t0 = time.perf_counter()
                    tower, g_emb, loss = step_fn(
                        tower, rows, torch.from_numpy(b["label"]).to(dev))
                    client.push(b["ids"], g_emb, lr=emb_lr)
                    finish(i, t0, loss)
            finally:
                client.close()
                loader.close()

        wall = time.perf_counter() - t_start
        tel = table.telemetry.totals()
        # cost-model bridge: the measured PS traffic re-anchors the CPU
        # resource type's bandwidth terms and yields a measured
        # embedding-layer ODT (the layer-profile shape the cost model
        # consumes)
        measured_res = table.telemetry.to_resource(CPU_CORE)
        odt_sync, odt_act = table.telemetry.embedding_odt(
            len(losses) * cfg.batch)
        hot_pulls = table.hot_pulls
        devices = {"tower": sorted({str(t.device) for v in tower.values()
                                    for t in v}),
                   "hot_cache": str(table.hot_rows.device)}
    finally:
        if own_table:
            table.close()
    return {
        "mode": mode, "steps": len(losses), "num_shards": table.num_shards,
        "first_loss": losses[0], "last_loss": losses[-1],
        "loss_decreased": losses[-1] < losses[0],
        "seconds": wall,
        "step_times": times,
        "step_ts": ts,
        "steps_per_sec": len(losses) / wall if wall > 0 else 0.0,
        "repins": placer.repins,
        "tier_stats": placer.last_stats,
        "pull_gb": tel["pull"]["bytes"] / 1e9,
        "push_gb": tel["push"]["bytes"] / 1e9,
        "pull_bw_gbs": tel["pull"]["bandwidth"] / 1e9,
        "push_bw_gbs": tel["push"]["bandwidth"] / 1e9,
        "hot_pull_fraction": tel["pull"]["hot_fraction"],
        "measured_ingest_bw": measured_res.ingest_bw,
        "measured_net_bw": measured_res.net_bw,
        "embedding_odt_sync": odt_sync,
        "embedding_odt_act": odt_act,
        "losses": losses,
        "pull_seconds": tel["pull"]["seconds"],
        "push_seconds": tel["push"]["seconds"],
        "hot_pulls": hot_pulls,
        "devices": devices,
    }


def train_ctr_elastic(cfg: CTRConfig | None = None, *, steps: int = 200,
                      num_shards: int = 3, optimizer: str = "sgd",
                      transport=None, mode: str = "sync",
                      events: list[tuple[int, str, int | None]] | None = None,
                      staleness_bound: int = 8, depth: int = 2,
                      rpc_latency_s: float = 0.0,
                      fault_schedule=None, fault_seed: int = 0,
                      ckpt_dir: str | None = None, ckpt_every: int = 0,
                      ckpt_keep: int = 2, max_restores: int = 4,
                      replan=None, log_every: int = 0, device=None,
                      dense=None, tower: dict | None = None) -> dict:
    """Train the CTR model over an **elastic** PS fleet, with scripted
    fleet events injected mid-training; the tower on ``device`` (default
    ``cuda``).

    ``events`` is a list of ``(step, action, shard)`` where ``action`` is
    ``"join"`` (shard ignored), ``"kill"`` or ``"leave"`` — e.g.
    ``[(40, "join", None), (80, "kill", 0)]`` grows the fleet at step 40
    and hard-kills shard 0 at step 80 (replica recovery kicks in on the
    next touch).  Training never pauses: the loop keeps issuing
    pull/push through every event.

    The sync replication + deterministic PS-hosted optimizer make the
    run's loss trajectory **bit-equal** (``mode="sync"``) to the same run
    without any events — the acceptance pin for lossless recovery.  The
    tower step and the push's dedup are deterministic on the card too
    (stream-ordered adds, TF32 off), so this holds there as well.

    Chaos knobs: ``fault_schedule`` (anything
    :func:`repro_torch.ps.faults.parse_schedule` accepts) wraps the
    transport in a seeded :class:`~repro_torch.ps.faults.FaultInjector`.
    ``ckpt_dir`` + ``ckpt_every`` arm periodic unified checkpoints
    (:class:`~repro_torch.ps.snapshot.FleetCheckpointer`); on a correlated
    primary+backup loss (:class:`PSUnrecoverable`) the loop restores the
    newest checkpoint, rewinds the (deterministic) batch stream to its
    cursor and **replays** — the loss trajectory from the restore step is
    bit-equal to a fault-free run (sync mode).

    ``replan`` is a factory ``fleet -> ReplanController`` (see
    ``core/replan.py``): the controller is built once the fleet exists,
    ``observe()``-d after every step, and its :meth:`report` lands in the
    result under ``"replan"``.

    Seams, as :func:`train_ctr_ps`'s: ``dense`` (e.g. the reference's
    initial table) replaces the fleet's seeded rows and ``tower`` (e.g.
    :func:`tower_from_numpy`) replaces :func:`init_tower`.  Returns the
    reference's summary plus the pull/push seconds and the ``devices``
    of the tower.
    """
    if mode not in ("sync", "async"):
        raise ValueError(f"mode must be sync|async, got {mode!r}")
    if ckpt_dir and ckpt_every and mode != "sync":
        raise ValueError("checkpoint/restore replay requires mode='sync' "
                         "(async pipelines have no exact cursor)")
    cfg = cfg or CTRConfig()
    dev = resolve_device(device)
    if fault_schedule is not None:
        transport = FaultInjector(make_transport(transport), fault_schedule,
                                  seed=fault_seed)
    fleet = make_fleet(cfg, num_shards, optimizer=optimizer,
                       transport=transport, staleness_bound=staleness_bound,
                       rpc_latency_s=rpc_latency_s, device=dev, dense=dense)
    by_step: dict[int, list[tuple[str, int | None]]] = {}
    for step, action, shard in (events or []):
        by_step.setdefault(int(step), []).append((action, shard))

    def fire(i: int) -> None:
        for action, shard in by_step.get(i, []):
            if action == "join":
                fleet.join()
            elif action == "kill":
                if shard in fleet.transport.live_shards:
                    fleet.kill(shard)
            elif action == "leave":
                if shard in fleet.transport.live_shards:
                    fleet.leave(shard)
            else:
                raise ValueError(f"unknown fleet event {action!r}")

    try:
        controller = replan(fleet) if replan is not None else None
        step_fn = make_step_fn(cfg)
        tower = (init_tower(cfg, device=dev) if tower is None else
                 {k: [t.to(dev) for t in v] for k, v in tower.items()})
        # the fleet's PS-hosted optimizer applies the lr server-side, so
        # the pushed payload is the raw (deduped, summed) gradient
        emb_lr = cfg.lr * cfg.emb_lr_scale
        losses: list[float] = []
        ts: list[float] = []
        t_start = time.perf_counter()

        def finish(i, loss):
            fire(i)
            losses.append(float(loss))
            ts.append(time.perf_counter() - t_start)
            if controller is not None:
                controller.observe(num_examples=cfg.batch)

        restores = 0
        ckpt: FleetCheckpointer | None = None
        if mode == "sync":
            if ckpt_dir and ckpt_every:
                ckpt = FleetCheckpointer(fleet, ckpt_dir, every=ckpt_every,
                                         keep=ckpt_keep)
            stream = click_stream(cfg)
            i = 0
            while i < steps:
                try:
                    b = next(stream)
                    rows = fleet.pull(b["ids"])
                    tower, g_emb, loss = step_fn(
                        tower, rows, torch.from_numpy(b["label"]).to(dev))
                    fleet.push(b["ids"], g_emb, lr=emb_lr)
                    finish(i, loss)
                    if ckpt is not None:
                        # post-step state: fleet slabs + tower + cursor i+1
                        ckpt.maybe_save(i, tower, metadata={
                            "cursor": i + 1, "seed": cfg.seed})
                    if log_every and i % log_every == 0:
                        print(f"step {i:4d} logloss {losses[-1]:.4f}",
                              flush=True)
                    i += 1
                except PSUnrecoverable:
                    # correlated primary+backup loss — replica promotion
                    # is out of moves; restore the newest unified
                    # checkpoint and replay the deterministic stream from
                    # its cursor
                    if ckpt is None or restores >= max_restores:
                        raise
                    restores += 1
                    ckpt.wait()
                    tower, snap, step0, _ = load_fleet_checkpoint(
                        ckpt_dir, params_template=tower)
                    fleet.restore_snapshot(snap)
                    del losses[step0 + 1:]
                    del ts[step0 + 1:]
                    stream = click_stream(cfg)
                    for _ in range(step0 + 1):   # skip replayed batches
                        next(stream)
                    i = step0 + 1
                    if log_every:
                        print(f"restored checkpoint step {step0}, "
                              f"replaying from step {i}", flush=True)
            if ckpt is not None:
                ckpt.wait()
        else:
            loader = PrefetchLoader(
                itertools.islice(click_stream(cfg), steps), depth=depth)
            client = PSClient(fleet, loader, ids_key="ids", depth=depth)
            try:
                for i, (b, rows) in enumerate(client):
                    tower, g_emb, loss = step_fn(
                        tower, rows, torch.from_numpy(b["label"]).to(dev))
                    client.push(b["ids"], g_emb, lr=emb_lr)
                    finish(i, loss)
            finally:
                client.close()
                loader.close()

        wall = time.perf_counter() - t_start
        tel = fleet.telemetry.totals()
        fleet_events = list(fleet.events)
        stats = fleet.stats()
        tr = fleet.transport
        transport_counters = dict(tr.counters)
        injections: list[dict] = []
        if isinstance(tr, FaultInjector):
            injections = list(tr.injections)
            for k, v in tr.inner.counters.items():
                transport_counters[k] = transport_counters.get(k, 0) + v
        devices = {"tower": sorted({str(t.device) for v in tower.values()
                                    for t in v})}
    finally:
        fleet.close()
    recoveries = [e for e in fleet_events if e["kind"] == "recover"]
    joins = [e for e in fleet_events if e["kind"] == "join"]
    replan_report = controller.report() if controller is not None else None
    return {
        "replan": replan_report,
        "mode": mode, "steps": len(losses), "optimizer": optimizer,
        "first_loss": losses[0], "last_loss": losses[-1],
        "loss_decreased": losses[-1] < losses[0],
        "losses": losses,
        "seconds": wall,
        "step_ts": ts,
        "steps_per_sec": len(losses) / wall if wall > 0 else 0.0,
        "live_shards": stats["live_shards"],
        "events": fleet_events,
        "recovery_seconds": sum(e["seconds"] for e in recoveries),
        "join_seconds": sum(e["seconds"] for e in joins),
        "restores": restores,
        "checkpoints": list(ckpt.saved) if ckpt is not None else [],
        "injections": injections,
        "transport_counters": transport_counters,
        "pull_gb": tel["pull"]["bytes"] / 1e9,
        "push_gb": tel["push"]["bytes"] / 1e9,
        "pull_seconds": tel["pull"]["seconds"],
        "push_seconds": tel["push"]["seconds"],
        "devices": devices,
    }
