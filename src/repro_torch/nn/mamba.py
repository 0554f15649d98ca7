"""Mamba selective-SSM block, Jamba's sequence mixer (port of
``repro.nn.mamba``).

The full sequence runs the reference's chunk structure: sequential over
time chunks of ``SCAN_CHUNK`` tokens with the SSM state carried across
them, a parallel scan within a chunk.  The reference scans a chunk with
``jax.lax.associative_scan``; here it is a Hillis-Steele doubling scan in
torch ops (log2(chunk) steps over the chunk's (B, C, d_inner, d_state)
tensors), so a prefill makes no Python step per token.  The scan combines
products of the discretized decays, never a cumulative sum of their logs:
``dt·A`` falls below -800 over a chunk and ``exp`` of such sums
overflows.  Decode carries the SSM state ``h (B, d_inner, d_state)`` and
the causal-conv window, O(1) work per token; its functions update the
caller's cache tensors in place and return them.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

#: time-chunk length of the selective scan (the reference's): bounds the
#: live (B, chunk, d_inner, d_state) float32 tensors to one chunk
SCAN_CHUNK = 512


def _normal(gen, shape, scale, device, dtype):
    return torch.randn(shape, generator=gen, device=device,
                       dtype=dtype).mul_(scale)


def init_mamba(gen: torch.Generator, d_model: int, *, d_state: int = 16,
               d_conv: int = 4, expand: int = 2, dt_rank: int | None = None,
               device=None, dtype=torch.float32):
    """The reference's leaves, distributions and scales."""
    din = expand * d_model
    dt_rank = dt_rank or max(1, d_model // 16)
    s, si = 1.0 / math.sqrt(d_model), 1.0 / math.sqrt(din)
    a_log = torch.log(torch.arange(1, d_state + 1, dtype=torch.float32,
                                   device=device)).expand(din, d_state)
    return {
        "in_proj": _normal(gen, (d_model, 2 * din), s, device, dtype),
        "conv_w": _normal(gen, (d_conv, din), 1.0 / math.sqrt(d_conv),
                          device, dtype),
        "conv_b": torch.zeros(din, device=device, dtype=dtype),
        "x_proj": _normal(gen, (din, dt_rank + 2 * d_state), si, device,
                          dtype),
        "dt_proj": _normal(gen, (dt_rank, din), 1.0 / math.sqrt(dt_rank),
                           device, dtype),
        # softplus⁻¹(0.01)
        "dt_bias": torch.full((din,), math.log(math.expm1(0.01)),
                              device=device, dtype=dtype),
        "A_log": a_log.to(dtype).contiguous(),
        "D": torch.ones(din, device=device, dtype=dtype),
        "out_proj": _normal(gen, (din, d_model), si, device, dtype),
    }


def _ssm_inputs(p, xc, dt_rank: int, d_state: int):
    """Per-step discretization, shared by the sequence and decode paths:
    (Ābar (..., din, N) float32, B̄·x (..., din, N) float32, C (..., N))."""
    proj = xc @ p["x_proj"]
    dt, Bc, Cc = torch.split(proj, [dt_rank, d_state, d_state], dim=-1)
    dt = F.softplus(dt @ p["dt_proj"] + p["dt_bias"])
    A = -torch.exp(p["A_log"].float())
    Abar = torch.exp(dt[..., None].float() * A)
    # B̄·x: Euler discretization dt·B·x
    Bx = (dt * xc)[..., None] * Bc[..., None, :].to(dt.dtype)
    return Abar, Bx.float(), Cc


def _scan(a, b):
    """Inclusive scan along dim 1 of ``h_t = a_t·h_{t-1} + b_t`` from
    h = 0: returns (∏_{s≤t} a_s, h_t) by Hillis-Steele doubling."""
    C = a.shape[1]
    off = 1
    while off < C:
        b = torch.cat([b[:, :off], a[:, off:] * b[:, :-off] + b[:, off:]],
                      dim=1)
        a = torch.cat([a[:, :off], a[:, off:] * a[:, :-off]], dim=1)
        off *= 2
    return a, b


def mamba(p, x, *, d_state: int = 16, d_conv: int = 4,
          chunk: int = SCAN_CHUNK, return_state: bool = False):
    """Full-sequence forward. x: (B, S, D) → (B, S, D).

    ``return_state=True`` also returns the decode cache after the
    sequence (``{"h", "conv"}``: what stepping :func:`decode_mamba` over
    the same tokens carries), for prefill."""
    B, S, _ = x.shape
    din = p["in_proj"].shape[1] // 2
    dt_rank = p["dt_proj"].shape[0]
    xc, z = torch.chunk(x @ p["in_proj"], 2, dim=-1)        # (B, S, din)
    # depthwise causal conv1d along time
    xpad = F.pad(xc, (0, 0, d_conv - 1, 0))
    conv_tail = xpad[:, S:]            # the last d_conv-1 pre-conv inputs
    xc = sum(xpad[:, i:i + S] * p["conv_w"][i] for i in range(d_conv))
    xc = F.silu(xc + p["conv_b"])

    C = min(chunk, S)
    if S % C:
        C = S                  # one chunk for ragged short sequences
    h = torch.zeros((B, din, d_state), dtype=torch.float32, device=x.device)
    ys = []
    for c in range(S // C):
        xc_c = xc[:, c * C:(c + 1) * C]
        Abar, Bx, Cc = _ssm_inputs(p, xc_c, dt_rank, d_state)
        a_cum, h_rel = _scan(Abar, Bx)
        hs = h_rel + a_cum * h[:, None]                     # carry state in
        ys.append(torch.einsum("bcdn,bcn->bcd", hs,
                               Cc.to(hs.dtype)).to(xc_c.dtype))
        h = hs[:, -1]
    y = torch.cat(ys, dim=1) + p["D"] * xc
    out = (y * F.silu(z)) @ p["out_proj"]
    if return_state:
        return out, {"h": h, "conv": conv_tail}
    return out


def init_mamba_cache(batch: int, d_model: int, *, d_state: int = 16,
                     d_conv: int = 4, expand: int = 2, dtype=torch.float32,
                     device=None):
    din = expand * d_model
    return {
        "h": torch.zeros((batch, din, d_state), dtype=torch.float32,
                         device=device),
        "conv": torch.zeros((batch, d_conv - 1, din), dtype=dtype,
                            device=device),
    }


def decode_mamba(p, x, cache, *, d_state: int = 16, d_conv: int = 4):
    """One-token decode. x: (B, 1, D).  Writes ``cache["h"]`` and
    ``cache["conv"]`` in place; returns (y (B, 1, D), cache)."""
    dt_rank = p["dt_proj"].shape[0]
    xc, z = torch.chunk(x[:, 0] @ p["in_proj"], 2, dim=-1)   # (B, din)
    window = torch.cat([cache["conv"], xc[:, None].to(cache["conv"].dtype)],
                       dim=1)
    xconv = F.silu(torch.einsum("bkd,kd->bd", window, p["conv_w"])
                   + p["conv_b"])
    Abar, Bx, Cc = _ssm_inputs(p, xconv, dt_rank, d_state)    # (B, din, N)
    h = Abar * cache["h"] + Bx
    y = torch.einsum("bdn,bn->bd", h, Cc.to(h.dtype)).to(x.dtype)
    y = (y + p["D"] * xconv) * F.silu(z)
    cache["h"].copy_(h)
    cache["conv"].copy_(window[:, 1:])
    return (y @ p["out_proj"])[:, None, :], cache
