"""Basic NN building blocks on tensors (port of ``repro.nn.base``)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def rmsnorm(x, w, *, eps: float = 1e-6):
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps)
    return (x * w).to(dt)


def layernorm(x, p, *, eps: float = 1e-5):
    dt = x.dtype
    x = x.float()
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps) * p["w"] + p["b"]
    return y.to(dt)


def softcap(x, cap: float):
    """Gemma-2 style logit soft-capping: cap·tanh(x/cap)."""
    return cap * torch.tanh(x / cap)


# --- rotary position embeddings -------------------------------------------


def rope_freqs(head_dim: int, theta: float = 10000.0, fraction: float = 1.0,
               *, device=None):
    """Inverse frequencies for the rotated part of the head dim."""
    rot = int(head_dim * fraction) // 2 * 2
    exps = torch.arange(0, rot, 2, dtype=torch.float32, device=device) / rot
    return 1.0 / (theta ** exps), rot


def apply_rope(x, positions, *, theta: float = 10000.0, fraction: float = 1.0):
    """x: (..., seq, heads, head_dim); positions: (..., seq).

    Rotates *interleaved* pairs ``(x[..., 0::2], x[..., 1::2])`` exactly as
    the reference does (not the half-split ``rotate_half`` layout).
    ``fraction < 1`` rotates only the first ``fraction`` of the head dim —
    ChatGLM's partial RoPE.
    """
    head_dim = x.shape[-1]
    inv, rot = rope_freqs(head_dim, theta, fraction, device=x.device)
    if rot == 0:
        return x
    ang = positions[..., :, None].float() * inv            # (..., seq, rot/2)
    cos = torch.cos(ang)[..., :, None, :]
    sin = torch.sin(ang)[..., :, None, :]
    xr, xp = x[..., :rot], x[..., rot:]
    x1, x2 = xr[..., 0::2], xr[..., 1::2]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    yr = torch.stack([y1, y2], dim=-1).reshape(xr.shape)
    return torch.cat([yr, xp], dim=-1).to(x.dtype)


def swiglu(x, w1, w3, w2):
    """SwiGLU FFN: (silu(x·w1) ⊙ x·w3)·w2."""
    return (F.silu(x @ w1) * (x @ w3)) @ w2
