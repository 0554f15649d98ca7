"""chatglm3-6b [dense] — 28L d_model=4096 32H (GQA kv=2) d_ff=13696
vocab=65024 — 2-d (partial) RoPE, GQA [arXiv:2406.12793]."""

from repro_torch.models.config import ArchConfig, LayerSpec

_LAYER = LayerSpec(mixer="attn", ffn="dense", rope_fraction=0.5)


def config() -> ArchConfig:
    return ArchConfig(
        name="chatglm3-6b", family="dense", source="arXiv:2406.12793",
        d_model=4096, n_heads=32, n_kv_heads=2, head_dim=128,
        d_ff=13696, vocab=65024,
        pattern=(_LAYER,), repeats=28,
        rope_theta=10000.0,
    )


def reduced() -> ArchConfig:
    return ArchConfig(
        name="chatglm3-6b-reduced", family="dense", source="smoke",
        d_model=256, n_heads=8, n_kv_heads=2, head_dim=32,
        d_ff=512, vocab=1024,
        pattern=(_LAYER,), repeats=2,
    )
