"""HeterPS stage pipeline — GPipe-style schedule on a ``stage`` mesh axis
(port of ``repro.parallel.pipeline``).

The paper (§3, §5.1) partitions the model into stages (consecutive layers
on one resource type, from the scheduling plan), runs data parallelism
*within* a stage and pipeline parallelism *between* stages, with
microbatches flowing stage to stage.  Here each rank of the ``stage``
axis of a DeviceMesh is one stage, and activations move between
neighbouring ranks with point-to-point sends (``batch_isend_irecv``).

The schedule is the reference's fill/drain loop: ``T = M + S - 1`` ticks
for ``M`` microbatches over ``S`` stages; at tick ``t`` every stage
computes, stage 0 on microbatch ``min(t, M - 1)`` and stage ``s`` on what
stage ``s - 1`` sent at tick ``t - 1`` (zeros at the first tick), so
stage ``s`` holds microbatch ``t - s`` once the pipeline is full.
``torch.distributed``'s sends are not differentiable, so the shift is an
autograd Function whose backward runs the reverse shift: autograd of the
pipelined loss is the backward pipeline, as ``jax.grad`` gives the
reference one through ``ppermute``.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from repro_torch.tree import tree_map


def make_stage_mesh(num_stages: int, *, device_type: str = "cuda",
                    backend: str | None = None):
    """A 1-D mesh of ``num_stages`` ranks with the axis ``stage``."""
    from repro_torch.launch.mesh import make_mesh

    return make_mesh((num_stages,), ("stage",), device_type=device_type,
                     backend=backend)


def _shift(x, group, step: int):
    """Send ``x`` to the stage ``step`` places on and return what the
    stage ``step`` places back sent (zeros where there is none)."""
    me, size = dist.get_rank(group), dist.get_world_size(group)
    out = torch.zeros_like(x)
    ops = []
    if 0 <= me + step < size:
        ops.append(dist.P2POp(dist.isend, x.contiguous(),
                              dist.get_global_rank(group, me + step), group))
    if 0 <= me - step < size:
        ops.append(dist.P2POp(dist.irecv, out,
                              dist.get_global_rank(group, me - step), group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return out


class _Shift(torch.autograd.Function):
    """``ppermute`` to the next stage; the backward shifts the gradient to
    the previous stage (the last stage receives zeros)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _shift(x, group, 1)

    @staticmethod
    def backward(ctx, g):
        return _shift(g, ctx.group, -1), None


class _FromLastStage(torch.autograd.Function):
    """The last stage's tensor on every rank.  Every rank computes the same
    loss from it, so the gradient is the last stage's own: unlike
    ``torch.distributed.nn.functional.broadcast``, whose backward sums
    the S ranks' (identical) gradients, nothing is summed."""

    @staticmethod
    def forward(ctx, x, group):
        src = dist.get_global_rank(group, dist.get_world_size(group) - 1)
        ctx.is_src = dist.get_rank() == src
        out = x.clone()
        dist.broadcast(out, src, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return (g if ctx.is_src else torch.zeros_like(g)), None


def _stage_slice(a, stage: int):
    """This stage's slice of a stacked (S, …) leaf: a DTensor sharded over
    the stage axis gives its local block, a plain tensor its row."""
    from torch.distributed.tensor import DTensor

    if isinstance(a, DTensor):
        return a.to_local()[0]
    return a[stage]


def pipeline_apply(stage_fn: Callable, stage_params, microbatches, mesh, *,
                   axis: str = "stage"):
    """Run ``microbatches`` through the stage pipeline.

    stage_fn: (params_one_stage, x (mb, d)) → y (mb, d) — the same
      callable for every stage (heterogeneity lives in the params).
    stage_params: tree with leading dim = num_stages — plain tensors
      (every rank holds all; the gradient of one holds this rank's row and
      zeros elsewhere) or DTensors sharded over ``axis``.
    microbatches: (M, mb, d) — M microbatches, the same on every rank.
    Returns (M, mb, d): the last stage's outputs in microbatch order, on
    every rank."""
    group = mesh.get_group(axis)
    S = dist.get_world_size(group)
    sidx = mesh.get_local_rank(axis)
    M = microbatches.shape[0]
    T = M + S - 1
    params_local = tree_map(lambda a: _stage_slice(a, sidx), stage_params)
    state = torch.zeros_like(microbatches[0])
    # a select, not a Python branch: stage 0's input depends on the shifted
    # state too (with a zero gradient), so every rank runs the backward of
    # every shift and the ranks' reverse sends pair up
    first = torch.tensor(sidx == 0, device=microbatches.device)
    outs = []
    for t in range(T):
        inp = torch.where(first, microbatches[min(t, M - 1)], state)
        y = stage_fn(params_local, inp)
        outs.append(y)
        if t < T - 1:
            state = _Shift.apply(y, group)
    # microbatch m exits the last stage at tick m + S - 1
    return _FromLastStage.apply(torch.stack(outs[S - 1:]), group)


def pipeline_loss(stage_fn: Callable, loss_fn: Callable, stage_params,
                  microbatches, labels, mesh, *, axis: str = "stage"):
    """Differentiable pipelined loss: mean over microbatches of
    ``loss_fn(last_stage_out, labels_mb)``.  Autograd of this w.r.t. the
    stage parameters runs the backward pipeline through the shifts."""
    outs = pipeline_apply(stage_fn, stage_params, microbatches, mesh,
                          axis=axis)
    losses = torch.stack([loss_fn(outs[m], labels[m])
                          for m in range(outs.shape[0])])
    return losses.mean()


def stack_stage_params(per_stage: list):
    """[stage trees with identical structure] → stacked (S, …) tree."""
    return tree_map(lambda *xs: torch.stack(xs), per_stage[0],
                    *per_stage[1:])
