"""RWKV-6 ("Finch") block: attention-free mixer with data-dependent decay
(port of ``repro.nn.rwkv``).

Time-mix keeps a per-head matrix state ``S (B, H, hd, hd)`` updated as
``S_t = diag(w_t)·S_{t-1} + kᵀ_t v_t``, where the decay ``w_t`` comes from
a low-rank LoRA of the shifted input.  The readout adds the bonus ``u``
for the current token.  The full sequence loops over tokens where the
reference scans (``lax.scan``), forming ``kᵀ_t v_t`` inside the step so
no (B, S, H, hd, hd) tensor exists; decode is the same step once.  The
state, the decay and ``u``'s products are float32, as in the reference.

Channel-mix: squared-ReLU gated FFN with token shift.

Decode functions update the caller's cache tensors in place and return
them (the reference returns fresh arrays).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.nn.base import rmsnorm
from repro_torch.parallel.act import shard_heads, shard_last_dim


def _normal(gen, shape, scale, device, dtype):
    return torch.randn(shape, generator=gen, device=device,
                       dtype=dtype).mul_(scale)


def _lora_init(gen, d: int, rank: int, out: int, device, dtype):
    return {"a": _normal(gen, (d, rank), 1.0 / math.sqrt(d), device, dtype),
            "b": torch.zeros((rank, out), device=device, dtype=dtype)}


def _lora(p, x):
    return torch.tanh(x @ p["a"]) @ p["b"]


def init_time_mix(gen: torch.Generator, d_model: int, *, head_size: int = 64,
                  decay_rank: int = 64, mix_rank: int = 32, device=None,
                  dtype=torch.float32):
    """The reference's leaves, distributions and scales: projections
    N(0, 1/d_model), LoRA ``a`` N(0, 1/d_model) and ``b`` zeros, ``mu``
    0.5, ``decay_base`` -6, ``u`` N(0, 0.01), ``ln_x`` ones."""
    H = d_model // head_size
    s = 1.0 / math.sqrt(d_model)

    def full(shape, value):
        return torch.full(shape, value, device=device, dtype=dtype)

    return {
        "mu": full((5, d_model), 0.5),         # static shift-mix r,k,v,g,w
        "mix_lora": _lora_init(gen, d_model, mix_rank, 5 * d_model, device,
                               dtype),
        "wr": _normal(gen, (d_model, d_model), s, device, dtype),
        "wk": _normal(gen, (d_model, d_model), s, device, dtype),
        "wv": _normal(gen, (d_model, d_model), s, device, dtype),
        "wg": _normal(gen, (d_model, d_model), s, device, dtype),
        "wo": _normal(gen, (d_model, d_model), s, device, dtype),
        "decay_base": full((d_model,), -6.0),
        "decay_lora": _lora_init(gen, d_model, decay_rank, d_model, device,
                                 dtype),
        "u": _normal(gen, (H, head_size), 0.1, device, dtype),
        "ln_x": torch.ones(d_model, device=device, dtype=dtype),
    }


def _five_streams(p, x, x_prev):
    """r, k, v, g, w inputs after the data-dependent token shift.
    x, x_prev: (..., D); returns five (..., D) tensors."""
    d = x.shape[-1]
    delta = x_prev - x
    lora = _lora(p["mix_lora"], x + 0.5 * delta)
    lora = lora.reshape(*lora.shape[:-1], 5, d)
    return [x + delta * (p["mu"][j] + lora[..., j, :]) for j in range(5)]


def _projections(p, x, x_prev, H: int, hd: int):
    """r, k, v (..., H, hd) and the decay w (..., H, hd) in float32, and
    the gate g (..., D) in x's dtype."""
    xr, xk, xv, xg, xw = _five_streams(p, x, x_prev)
    shape = (*x.shape[:-1], H, hd)
    r = shard_heads((xr @ p["wr"]).reshape(shape), axis=-2).float()
    k = shard_heads((xk @ p["wk"]).reshape(shape), axis=-2).float()
    v = shard_heads((xv @ p["wv"]).reshape(shape), axis=-2).float()
    g = F.silu(xg @ p["wg"])
    # data-dependent decay in (0, 1): w = exp(-exp(base + lora(xw)))
    w = torch.exp(-torch.exp(p["decay_base"] + _lora(p["decay_lora"], xw)))
    return r, k, v, w.reshape(shape).float(), g


def _wkv_step(state, r_t, k_t, v_t, w_t, u):
    """One token: (out (B, H, hd), new state) from the state (B, H, hd,
    hd) and the token's r, k, v, w (B, H, hd), all float32."""
    kv = k_t[..., :, None] * v_t[..., None, :]
    out = torch.einsum("bhi,bhij->bhj", r_t, state + u[None, :, :, None] * kv)
    return out, w_t[..., None] * state + kv


def time_mix(p, x, *, head_size: int = 64, return_state: bool = False):
    """Full-sequence time-mix. x: (B, S, D) → (B, S, D).

    ``return_state=True`` also returns the decode cache after the
    sequence (``{"state", "tm_shift"}``), for prefill."""
    B, S, D = x.shape
    H = D // head_size
    x_prev = F.pad(x, (0, 0, 1, 0))[:, :S]
    r, k, v, w, g = _projections(p, x, x_prev, H, head_size)
    state = torch.zeros((B, H, head_size, head_size), dtype=torch.float32,
                        device=x.device)
    outs = []
    for t in range(S):
        o, state = _wkv_step(state, r[:, t], k[:, t], v[:, t], w[:, t],
                             p["u"])
        outs.append(o)
    out = torch.stack(outs, dim=1).reshape(B, S, D)
    out = rmsnorm(out, p["ln_x"])                     # group-norm stand-in
    y = (out.to(x.dtype) * g) @ p["wo"]
    if return_state:
        return y, {"state": state, "tm_shift": x[:, -1].float()}
    return y


def init_channel_mix(gen: torch.Generator, d_model: int, d_ff: int, *,
                     device=None, dtype=torch.float32):
    s = 1.0 / math.sqrt(d_model)
    return {
        "mu_k": torch.full((d_model,), 0.5, device=device, dtype=dtype),
        "mu_r": torch.full((d_model,), 0.5, device=device, dtype=dtype),
        "wk": _normal(gen, (d_model, d_ff), s, device, dtype),
        "wv": _normal(gen, (d_ff, d_model), 1.0 / math.sqrt(d_ff), device,
                      dtype),
        "wr": _normal(gen, (d_model, d_model), s, device, dtype),
    }


def channel_mix(p, x, x_prev):
    xk = x + (x_prev - x) * p["mu_k"]
    xr = x + (x_prev - x) * p["mu_r"]
    k = shard_last_dim(torch.square(F.relu(xk @ p["wk"])))
    return torch.sigmoid(xr @ p["wr"]) * (k @ p["wv"])


def channel_mix_seq(p, x):
    S = x.shape[1]
    return channel_mix(p, x, F.pad(x, (0, 0, 1, 0))[:, :S])


def init_rwkv_cache(batch: int, d_model: int, *, head_size: int = 64,
                    device=None):
    H = d_model // head_size
    f32 = torch.float32
    return {
        "state": torch.zeros((batch, H, head_size, head_size), dtype=f32,
                             device=device),
        "tm_shift": torch.zeros((batch, d_model), dtype=f32, device=device),
        "cm_shift": torch.zeros((batch, d_model), dtype=f32, device=device),
    }


def decode_time_mix(p, x, cache, *, head_size: int = 64):
    """One-token time-mix. x: (B, 1, D).  Writes ``cache["state"]`` and
    ``cache["tm_shift"]`` in place; returns (y (B, 1, D), cache)."""
    B, _, D = x.shape
    H = D // head_size
    xt = x[:, 0]
    r, k, v, w, g = _projections(p, xt, cache["tm_shift"].to(xt.dtype), H,
                                 head_size)
    out, state = _wkv_step(cache["state"], r, k, v, w, p["u"])
    out = rmsnorm(out.reshape(B, D), p["ln_x"]).to(x.dtype)
    cache["state"].copy_(state)
    cache["tm_shift"].copy_(xt)
    return ((out * g) @ p["wo"])[:, None, :], cache


def decode_channel_mix(p, x, cache):
    """One-token channel-mix. x: (B, 1, D).  Writes ``cache["cm_shift"]``
    in place; returns (y (B, 1, D), cache)."""
    xt = x[:, 0]
    y = channel_mix(p, xt, cache["cm_shift"].to(xt.dtype))
    cache["cm_shift"].copy_(xt)
    return y[:, None, :], cache
