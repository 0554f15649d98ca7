"""llama-3.2-vision-11b [vlm] — 40L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=128256 — cross-attention image layers
[hf:meta-llama/Llama-3.2-11B-Vision].

Backbone only, as in the reference: the ViT vision encoder + projector
is a stub — callers pass projected patch embeddings (B, 1601, 4096) as
``context``, consumed by the cross-attention layers.  Pattern: every
5th layer is a cross-attention layer (8 of 40), matching the model card.
"""

from repro_torch.models.config import ArchConfig, LayerSpec

_SELF = LayerSpec(mixer="attn", ffn="dense")
_CROSS = LayerSpec(mixer="cross_attn", ffn="dense", rope=False)


def config() -> ArchConfig:
    return ArchConfig(
        name="llama-3.2-vision-11b", family="vlm",
        source="hf:meta-llama/Llama-3.2-11B-Vision",
        d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
        d_ff=14336, vocab=128256,
        pattern=(_SELF, _SELF, _SELF, _SELF, _CROSS), repeats=8,
        rope_theta=500000.0, cross_kv_len=1601,
    )


def reduced() -> ArchConfig:
    return ArchConfig(
        name="llama-3.2-vision-11b-reduced", family="vlm", source="smoke",
        d_model=256, n_heads=4, n_kv_heads=2, head_dim=64,
        d_ff=512, vocab=1024,
        pattern=(_SELF, _CROSS), repeats=1,
        rope_theta=500000.0, cross_kv_len=64,
    )
