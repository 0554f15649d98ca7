"""Feed-forward layers: dense SwiGLU and top-k MoE with capacity dispatch
(port of ``repro.nn.moe``).

The MoE uses GShard-style grouped dispatch with a per-expert capacity
(capacity factor 1.25 by default): each sequence is a routing group,
static shapes, tokens over a group's capacity dropped through the
residual path.  The router's load-balance auxiliary loss follows Switch
Transformer.  The row movement around the expert matmuls goes through
:mod:`repro_torch.kernels.ops` (the CUDA kernels for CUDA tensors, the
slot gathers for CPU tensors); ``impl="ref"`` keeps the scatter/gather
oracle.  The expert SwiGLU itself is three batched matrix products.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

from repro_torch.obs.trace import span
from repro_torch.parallel.act import (per_expert, shard_batch_act,
                                      shard_last_dim, shard_moe_group_buffer)


def _normal(gen, shape, scale, device, dtype):
    return torch.randn(shape, generator=gen, device=device,
                       dtype=dtype).mul_(scale)


def init_dense_ffn(gen: torch.Generator, d_model: int, d_ff: int, *,
                   device=None, dtype=torch.float32):
    """Same distributions and scales as the reference: N(0, 1/d_model)
    for the two input projections, N(0, 1/d_ff) for the output."""
    s_in, s_out = 1.0 / math.sqrt(d_model), 1.0 / math.sqrt(d_ff)
    return {
        "w1": _normal(gen, (d_model, d_ff), s_in, device, dtype),
        "w3": _normal(gen, (d_model, d_ff), s_in, device, dtype),
        "w2": _normal(gen, (d_ff, d_model), s_out, device, dtype),
    }


def dense_ffn(p, x):
    return shard_last_dim(F.silu(x @ p["w1"]) * (x @ p["w3"])) @ p["w2"]


def init_moe(gen: torch.Generator, d_model: int, d_ff: int,
             num_experts: int, *, router_scale: float | None = None,
             device=None, dtype=torch.float32):
    """Router (d, E) and per-expert SwiGLU weights (E, d, f) / (E, f, d),
    with the reference's distributions and scales."""
    s_in, s_out = 1.0 / math.sqrt(d_model), 1.0 / math.sqrt(d_ff)
    E = num_experts
    return {
        "router": _normal(gen, (d_model, E), router_scale or s_in, device,
                          dtype),
        "w1": _normal(gen, (E, d_model, d_ff), s_in, device, dtype),
        "w3": _normal(gen, (E, d_model, d_ff), s_in, device, dtype),
        "w2": _normal(gen, (E, d_ff, d_model), s_out, device, dtype),
    }


def _expert_swiglu(buf, w1, w3, w2):
    """Batched expert SwiGLU over the expert dim: (G, E, C, D) → (G, E,
    C, D)."""
    h = F.silu(torch.einsum("gecd,edf->gecf", buf, w1))
    h = h * torch.einsum("gecd,edf->gecf", buf, w3)
    return torch.einsum("gecf,efd->gecd", h, w2)


def moe_capacity(num_tokens: int, num_experts: int, top_k: int,
                 capacity_factor: float = 1.25) -> int:
    cap = int(math.ceil(num_tokens * top_k * capacity_factor / num_experts))
    return max(8, -(-cap // 8) * 8)  # round up to 8, as the reference


def _top_k(probs, k: int):
    """``jax.lax.top_k``: the k largest along the last axis, ties ordered
    lower index first (a stable descending sort; ``torch.topk`` promises
    no order among equal values)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_route(router, x, *, top_k: int, capacity: int):
    """Top-k capacity routing for ``x (G, S, D)``.

    Returns ``(probs, gate, eid_f, pos, keep)``: probs (G, S, E) router
    softmax in float32; gate (G, S, K) renormalised top-k weights; and
    eid_f / pos / keep (G, S·K) flat per-(token, k) expert id (int32),
    position-in-expert (an exclusive running count within the group,
    int32) and under-capacity mask.  Integer tensor ops only: no
    device→host sync."""
    G, S, _ = x.shape
    E = router.shape[1]
    K = top_k

    logits = (x @ router).float()                            # (G, S, E)
    probs = torch.softmax(logits, dim=-1)
    gate, eid = _top_k(probs, K)                             # (G, S, K)
    gate = gate / gate.sum(-1, keepdim=True).clamp_min(1e-9)

    eid_f = eid.reshape(G, S * K)                            # (G, NK)
    onehot = F.one_hot(eid_f, E)                             # (G, NK, E)
    pos_in_e = onehot.cumsum(dim=1) - 1                      # exclusive rank
    pos = torch.gather(pos_in_e, 2, eid_f[..., None])[..., 0]
    keep = pos < capacity
    return (probs, gate, eid_f.to(torch.int32), pos.to(torch.int32), keep)


def ref_dispatch(x, eid_f, safe_pos, keep, *, num_experts: int,
                 capacity: int, top_k: int):
    """Oracle scatter dispatch: K-repeated source + accumulating scatter
    into the (E, C) capacity slabs."""
    G, S, D = x.shape
    E, C, K = num_experts, capacity, top_k
    src = x.repeat_interleave(K, dim=1) * keep[..., None].to(x.dtype)
    rows = torch.arange(G, device=x.device)[:, None].expand(G, S * K)
    buf = torch.zeros((G, E, C, D), dtype=x.dtype, device=x.device)
    return buf.index_put_((rows, eid_f.long(), safe_pos.long()), src,
                          accumulate=True)


def ref_combine(buf, eid_f, safe_pos, w, *, top_k: int):
    """Oracle gather combine: explicit (G, N·K, D) gather + gate-weighted
    sum over k.  ``w (G, N·K)`` is the gate·keep weight."""
    G, NK = eid_f.shape
    S, K = NK // top_k, top_k
    D = buf.shape[-1]
    rows = torch.arange(G, device=buf.device)[:, None]
    y_f = buf[rows, eid_f.long(), safe_pos.long()]           # (G, NK, D)
    return (y_f * w[..., None].to(y_f.dtype)).reshape(G, S, K, D).sum(2)


def _no_span(name, cat):
    return contextlib.nullcontext()


def _moe(p, x, *, top_k: int, capacity_factor: float, impl: str,
         spans: bool):
    """Route, dispatch, expert SwiGLU and combine: ``(y, probs, eid_f,
    keep)``, the routing kept for :func:`moe_ffn`'s aux terms.  With
    ``spans`` (training) each stage is a span: ``moe.route``,
    ``moe.dispatch``, ``moe.experts``, ``moe.combine``; serving's decode
    steps, which the host bounds, record none."""
    B, S, D = x.shape
    E = p["router"].shape[1]
    K = top_k
    C = moe_capacity(S, E, K, capacity_factor)               # per group
    stage = span if spans else _no_span

    with stage("moe.route", "model"):
        probs, gate, eid_f, pos, keep = moe_route(p["router"], x, top_k=K,
                                                  capacity=C)
        safe_pos = torch.where(keep, pos, 0)

    with stage("moe.dispatch", "model"):
        if impl == "ref":
            buf = ref_dispatch(x, eid_f, safe_pos, keep, num_experts=E,
                               capacity=C, top_k=K)          # (G, E, C, D)
        else:
            from repro_torch.kernels import ops as kops

            buf = kops.moe_dispatch(x, eid_f, pos, keep.to(torch.float32),
                                    num_experts=E, capacity=C, top_k=K,
                                    impl=impl)
        buf = shard_moe_group_buffer(buf)

    with stage("moe.experts", "model"):
        out = shard_moe_group_buffer(
            per_expert(_expert_swiglu, buf, p["w1"], p["w3"], p["w2"]))

    with stage("moe.combine", "model"):
        w = (gate.reshape(B, S * K) * keep).to(x.dtype)
        if impl == "ref":
            y = ref_combine(out, eid_f, safe_pos, w, top_k=K)
        else:
            y = kops.moe_combine(out, eid_f.reshape(B, S, K),
                                 safe_pos.reshape(B, S, K),
                                 w.reshape(B, S, K), impl=impl)
    return shard_batch_act(y), probs, eid_f, keep


def moe_forward(p, x, *, top_k: int, capacity_factor: float = 1.25,
                impl: str = "auto"):
    """x: (B, S, D) → y (B, S, D): :func:`moe_ffn` without the aux-loss
    terms, which serving never reads (so it never computes them)."""
    return _moe(p, x, top_k=top_k, capacity_factor=capacity_factor,
                impl=impl, spans=False)[0]


def moe_ffn(p, x, *, top_k: int, capacity_factor: float = 1.25,
            impl: str = "auto"):
    """x: (B, S, D) → (y (B, S, D), aux) with aux the load-balance loss
    terms ``{"aux_loss", "dropped"}`` (tensors; reading them syncs).

    Each sequence is a routing group with capacity
    C = :func:`moe_capacity` (S, E, K, cf).  ``impl``: ``ref`` is the
    scatter/gather oracle; ``auto``/``slot``/``cuda`` route the data
    movement through :mod:`repro_torch.kernels.ops`."""
    y, probs, eid_f, keep = _moe(p, x, top_k=top_k,
                                 capacity_factor=capacity_factor, impl=impl,
                                 spans=True)
    B, S, _ = x.shape
    E = p["router"].shape[1]

    # Switch-style load-balance aux loss
    eid = eid_f.reshape(B, S, top_k)
    density = F.one_hot(eid[..., 0].long(), E).float().mean((0, 1))
    mean_prob = probs.mean((0, 1))
    aux = E * torch.sum(density * mean_prob)
    return y, {"aux_loss": aux, "dropped": 1.0 - keep.float().mean()}
