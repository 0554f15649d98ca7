"""Feed-forward layers (port of ``repro.nn.moe``).

Only the dense SiLU-gated FFN is ported so far; the MoE router, dispatch
and combine come with the MoE slice (ROADMAP.md queue 1 item 7).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def init_dense_ffn(gen: torch.Generator, d_model: int, d_ff: int, *,
                   device=None, dtype=torch.float32):
    """Same distributions and scales as the reference: N(0, 1/d_model)
    for the two input projections, N(0, 1/d_ff) for the output."""
    s_in, s_out = 1.0 / math.sqrt(d_model), 1.0 / math.sqrt(d_ff)

    def normal(shape, s):
        return torch.randn(shape, generator=gen, device=device,
                           dtype=dtype) * s

    return {
        "w1": normal((d_model, d_ff), s_in),
        "w3": normal((d_model, d_ff), s_in),
        "w2": normal((d_ff, d_model), s_out),
    }


def dense_ffn(p, x):
    return (F.silu(x @ p["w1"]) * (x @ p["w3"])) @ p["w2"]
