"""Architecture configuration — field-for-field mirror of
``repro.models.config`` (one schema for every arch of the reference).

A model is a *pattern* of :class:`LayerSpec`s repeated ``repeats`` times
(total layers = ``len(pattern) × repeats``).  Parameters of the repeated
pattern are stacked on a leading ``repeats`` axis, as in the reference,
so weights convert one-to-one (:mod:`repro_torch.models.convert`).
"""

from __future__ import annotations

import dataclasses
from typing import Literal

Mixer = Literal["attn", "cross_attn", "attn+cross", "mamba", "rwkv"]
Ffn = Literal["dense", "moe", "channel_mix", "none"]


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    mixer: Mixer = "attn"
    ffn: Ffn = "dense"
    window: int | None = None           # sliding-window attention (local)
    logit_softcap: float | None = None  # Gemma-2 attn soft-cap
    rope: bool = True
    rope_fraction: float = 1.0          # ChatGLM partial rotary
    qk_norm: bool = False               # Qwen3/OLMoE per-head q/k RMSNorm
    post_norm: bool = False             # Gemma-2 extra post-norms


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    """Whisper-style bidirectional encoder over stub frame embeddings."""

    num_layers: int
    frames: int                         # encoder sequence length (stub input)


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: Literal["dense", "moe", "ssm", "hybrid", "audio", "vlm"]
    source: str                         # paper / model-card citation
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    pattern: tuple[LayerSpec, ...]
    repeats: int
    # MoE
    moe_experts: int = 0
    moe_top_k: int = 0
    moe_d_ff: int = 0                   # per-expert FFN width
    moe_capacity_factor: float = 1.25   # GShard per-group expert capacity
    #: MoE dispatch/combine data path (kernels/ops.py): "auto" → the CUDA
    #: kernels for CUDA tensors, the slot gathers for CPU tensors; "slot"
    #: / "cuda" force a path; "ref" pins the scatter/gather oracle
    moe_impl: str = "auto"
    #: decode KV-cache layout: "dense" = per-sequence ring buffers (the
    #: oracle); "paged" = shared page pool + per-sequence page tables
    #: (kernels/paged_attention.py) — within the paged path the kernel
    #: resolves via kernels/ops.py impl="auto" (the CUDA kernel for CUDA
    #: tensors, the plain gather for CPU tensors)
    kv_impl: str = "dense"
    # positions
    rope_theta: float = 10000.0
    pos_embed: Literal["rope", "learned", "none"] = "rope"
    max_position: int = 0               # for learned positions
    # output head
    final_softcap: float | None = None
    tie_embeddings: bool = False
    embed_scale: bool = False           # Gemma: embeddings × sqrt(d_model)
    norm: Literal["rms", "ln"] = "rms"
    # Mamba (hybrid)
    mamba_d_state: int = 16
    mamba_d_conv: int = 4
    mamba_expand: int = 2
    # RWKV
    rwkv_head_size: int = 64
    # frontends (audio conv / ViT are stubs; the launcher provides
    # precomputed embeddings of this length)
    encoder: EncoderConfig | None = None
    cross_kv_len: int = 0               # image patches / audio frames
    # which input shapes this arch supports (long_500k needs sub-quadratic)
    supports_long_context: bool = False
    #: grad-accumulation microbatch (global examples)
    train_microbatch: int = 32

    @property
    def num_layers(self) -> int:
        return len(self.pattern) * self.repeats

    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a multiple of 256, as in the reference (the
        embedding and the tied head keep the reference's shapes)."""
        return -(-self.vocab // 256) * 256

    @property
    def has_moe(self) -> bool:
        return any(s.ffn == "moe" for s in self.pattern)

    def validate(self) -> None:
        if self.n_heads % max(self.n_kv_heads, 1) != 0:
            raise ValueError(f"{self.name}: n_heads % n_kv_heads != 0")
        if self.has_moe and not (self.moe_experts > 0 and self.moe_top_k > 0):
            raise ValueError(f"{self.name}: MoE layers need experts/top_k")
        for s in self.pattern:
            if s.mixer in ("cross_attn", "attn+cross") and self.cross_kv_len <= 0:
                raise ValueError(f"{self.name}: cross-attention needs "
                                 "cross_kv_len > 0")
        if self.pos_embed == "learned" and self.max_position <= 0:
            raise ValueError(f"{self.name}: learned positions need "
                             "max_position > 0")
