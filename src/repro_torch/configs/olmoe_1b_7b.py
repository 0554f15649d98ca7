"""olmoe-1b-7b [moe] — 16L d_model=2048 16H (GQA kv=16) d_ff=1024
vocab=50304, MoE 64e top-8 [arXiv:2409.02060]."""

from repro_torch.models.config import ArchConfig, LayerSpec

_LAYER = LayerSpec(mixer="attn", ffn="moe", qk_norm=True)


def config() -> ArchConfig:
    return ArchConfig(
        name="olmoe-1b-7b", family="moe", source="arXiv:2409.02060",
        d_model=2048, n_heads=16, n_kv_heads=16, head_dim=128,
        d_ff=1024, vocab=50304,
        pattern=(_LAYER,), repeats=16,
        moe_experts=64, moe_top_k=8, moe_d_ff=1024,
    )


def reduced() -> ArchConfig:
    return ArchConfig(
        name="olmoe-1b-7b-reduced", family="moe", source="smoke",
        d_model=256, n_heads=4, n_kv_heads=4, head_dim=64,
        d_ff=256, vocab=1024,
        pattern=(_LAYER,), repeats=2,
        moe_experts=4, moe_top_k=2, moe_d_ff=256,
    )
