"""qwen3-moe-30b-a3b [moe] — 48L d_model=2048 32H (GQA kv=4) d_ff=768
(per-expert), vocab=151936, MoE 128e top-8 [hf:Qwen/Qwen3-30B-A3B]."""

from repro_torch.models.config import ArchConfig, LayerSpec

_LAYER = LayerSpec(mixer="attn", ffn="moe", qk_norm=True)


def config() -> ArchConfig:
    return ArchConfig(
        name="qwen3-moe-30b-a3b", family="moe", source="hf:Qwen/Qwen3-30B-A3B",
        d_model=2048, n_heads=32, n_kv_heads=4, head_dim=128,
        d_ff=768, vocab=151936,
        pattern=(_LAYER,), repeats=48,
        moe_experts=128, moe_top_k=8, moe_d_ff=768,
        rope_theta=1000000.0,
    )


def reduced() -> ArchConfig:
    return ArchConfig(
        name="qwen3-moe-30b-a3b-reduced", family="moe", source="smoke",
        d_model=256, n_heads=4, n_kv_heads=2, head_dim=64,
        d_ff=128, vocab=1024,
        pattern=(_LAYER,), repeats=2,
        moe_experts=4, moe_top_k=2, moe_d_ff=128,
        rope_theta=1000000.0,
    )
