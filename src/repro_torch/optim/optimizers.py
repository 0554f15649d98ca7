"""AdamW / SGD + gradient clipping on trees of tensors (port of
``repro.optim.optimizers``).

The moments mirror the parameter tree leaf for leaf.  Unlike the
reference, whose arrays are immutable, the updates work **in place**:
parameters, ``mu`` and ``nu`` are overwritten and returned, so a step
holds no second copy of them (at llama3.2-1b's full width each tree is
5 GB in float32).  The arithmetic is the reference's, operation for
operation, in each leaf's dtype.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.tree import tree_leaves, tree_map


@dataclasses.dataclass
class OptState:
    mu: Any
    nu: Any
    count: torch.Tensor   # () int32, on the parameters' device


def adamw_init(params) -> OptState:
    leaves = tree_leaves(params)
    dev = leaves[0].device if leaves else None
    return OptState(mu=tree_map(torch.zeros_like, params),
                    nu=tree_map(torch.zeros_like, params),
                    count=torch.zeros((), dtype=torch.int32, device=dev))


@torch.no_grad()
def clip_by_global_norm(grads, max_norm: float):
    """Scale ``grads`` (in place) so their global L2 norm is at most
    ``max_norm``; returns (grads, the norm before clipping) with the norm a
    float32 device scalar (no host sync)."""
    leaves = tree_leaves(grads)
    g2 = sum(torch.sum(torch.square(g.float())) for g in leaves)
    norm = torch.sqrt(g2)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    for g in leaves:
        g.mul_(scale.to(g.dtype))
    return grads, norm


@torch.no_grad()
def adamw_update(params, grads, state: OptState, *, lr: float,
                 b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.0):
    """One AdamW step, in place on ``params`` and the moments; returns
    (params, state) with ``state.count`` advanced."""
    count = state.count + 1
    c1 = 1 - b1 ** count.float()
    c2 = 1 - b2 ** count.float()
    for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads),
                          tree_leaves(state.mu), tree_leaves(state.nu)):
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * torch.square(g))
        step = (m / c1) / (torch.sqrt(v / c2) + eps)
        if weight_decay:
            step = step + weight_decay * p
        p.sub_((lr * step).to(p.dtype))
    return params, OptState(mu=state.mu, nu=state.nu, count=count)


@torch.no_grad()
def sgd_update(params, grads, *, lr: float):
    """``p -= lr · g``, in place; returns params."""
    for p, g in zip(tree_leaves(params), tree_leaves(grads)):
        p.sub_((lr * g).to(p.dtype))
    return params
