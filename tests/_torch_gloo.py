"""Multi-process helpers of the port's mesh tests: ``run_gloo`` runs a
function on every rank of a ``gloo`` process group in spawned processes,
under a time limit, and the workers below are what the tests run there.
This module imports torch and the port only (never jax), so a spawned
rank starts quickly."""

from __future__ import annotations

import datetime
import multiprocessing as mp
import os
import queue
import tempfile
import time
import traceback

import numpy as np


def _entry(fn, rank, world, path, args, out):
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    try:
        dist.init_process_group(
            "gloo", init_method=f"file://{path}", rank=rank,
            world_size=world, timeout=datetime.timedelta(seconds=60))
        try:
            out.put((rank, "ok", fn(rank, world, *args)))
        finally:
            dist.destroy_process_group()
    except BaseException:
        out.put((rank, "error", traceback.format_exc()))


def run_gloo(fn, world: int, *args, timeout: float = 120.0) -> list:
    """``fn(rank, world, *args)`` on each of ``world`` spawned ranks of a
    gloo group (rendezvous on a file, 60 s collective timeout); returns
    the ranks' results in rank order.  Raises when a rank fails or the
    whole run outlasts ``timeout`` seconds; no process is left running."""
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    fd, path = tempfile.mkstemp(prefix="gloo_")
    os.close(fd)
    os.unlink(path)
    procs = [ctx.Process(target=_entry, args=(fn, r, world, path, args, out),
                         daemon=True) for r in range(world)]
    for p in procs:
        p.start()
    results, deadline = {}, time.monotonic() + timeout
    try:
        while len(results) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"gloo ranks did not finish in "
                                   f"{timeout} s: got {sorted(results)}")
            try:
                rank, status, value = out.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [p for p in procs if p.exitcode not in (None, 0)]
                if dead and len(results) < world and out.empty():
                    time.sleep(0.5)
                    if out.empty():
                        raise RuntimeError(
                            f"a gloo rank exited with {dead[0].exitcode}")
                continue
            if status != "ok":
                raise RuntimeError(f"gloo rank {rank} failed:\n{value}")
            results[rank] = value
    finally:
        for p in procs:
            p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
        if os.path.exists(path):
            os.unlink(path)
    assert not any(p.is_alive() for p in procs)
    return [results[r] for r in range(world)]


def _full(t):
    from torch.distributed.tensor import DTensor

    t = t.full_tensor() if isinstance(t, DTensor) else t
    return t.detach().numpy()


def mesh_loss_worker(rank, world, arch, weights, batch):
    """``loss_fn`` and every gradient of the reduced ``arch`` with DTensor
    parameters laid out by ``param_specs`` on a 2×2 (data, model) mesh and
    the batch from ``shard_batch``; returns (loss, {path: grad}) and the
    placements seen."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import shard_batch
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import decoder as dec
    from repro_torch.parallel import act
    from repro_torch.parallel import sharding as shd
    from repro_torch.tree import tree_leaves, tree_map, tree_map_with_path

    cfg = get_config(arch, reduced=True)
    mesh = make_mesh((2, 2), ("data", "model"), device_type="cpu")
    params = tree_map(torch.from_numpy, weights)
    dparams = tree_map(lambda t: t.requires_grad_(True), shd.distribute(
        params, shd.param_specs(params, cfg, mesh), mesh))
    dbatch = shard_batch(batch, mesh)
    with act.use_mesh(mesh):
        loss = dec.loss_fn(dparams, cfg, dbatch, compute_dtype=torch.float32,
                           remat=False)
        grads = torch.autograd.grad(loss, tree_leaves(dparams))
    paths = []
    tree_map_with_path(lambda p, _: paths.append("/".join(map(str, p))),
                       params)
    placed = sorted({str(g.placements) for g in grads})
    return (float(_full(loss)), {p: _full(g) for p, g in zip(paths, grads)},
            placed, [str(t.placements) for t in dbatch.values()])


def pipeline_worker(rank, world, per_stage, xs, labels):
    """The reference's 4-stage case on ``world`` gloo stages: the pipeline's
    outputs, loss and gradients (summed over the stages: each rank's
    gradient holds its own stage's row)."""
    import torch
    import torch.distributed as dist

    from repro_torch.parallel.pipeline import (make_stage_mesh,
                                               pipeline_apply, pipeline_loss,
                                               stack_stage_params)
    from repro_torch.tree import tree_leaves, tree_map

    mesh = make_stage_mesh(world, device_type="cpu")
    params = stack_stage_params(
        [tree_map(torch.from_numpy, p) for p in per_stage])
    leaves = [t.requires_grad_(True) for t in tree_leaves(params)]
    xs, labels = torch.from_numpy(xs), torch.from_numpy(labels)

    def stage_fn(p, x):
        return torch.tanh(x @ p["w"] + p["b"])

    def loss_fn(y, t):
        return torch.mean((y - t) ** 2)

    out = pipeline_apply(stage_fn, params, xs, mesh)
    loss = pipeline_loss(stage_fn, loss_fn, params, xs, labels, mesh)
    grads = [g.clone() for g in torch.autograd.grad(loss, leaves)]
    for g in grads:
        dist.all_reduce(g)
    return (out.detach().numpy(), float(loss.detach()),
            [g.numpy() for g in grads])


def shard_offsets_worker(rank, world, shape, specs):
    """Each rank's local block of an ``arange`` tensor of ``shape`` for
    each spec, laid out by :func:`placements` on a 2×2 mesh."""
    import torch

    from repro_torch.launch.mesh import make_mesh
    from repro_torch.parallel import sharding as shd

    mesh = make_mesh((2, 2), ("data", "model"), device_type="cpu")
    full = torch.arange(int(np.prod(shape)), dtype=torch.float32).reshape(
        shape)
    return {str(s): shd.distribute(full, s, mesh).to_local().numpy()
            for s in specs}, tuple(mesh.get_coordinate())
