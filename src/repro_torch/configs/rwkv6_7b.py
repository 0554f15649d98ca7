"""rwkv6-7b [ssm] — 32L d_model=4096 (attention-free) d_ff=14336
vocab=65536 — Finch, data-dependent decay [arXiv:2404.05892].

Attention-free recurrent state → runs ``long_500k`` natively (O(1)
per-token state, no KV growth).
"""

from repro_torch.models.config import ArchConfig, LayerSpec

_LAYER = LayerSpec(mixer="rwkv", ffn="channel_mix", rope=False)


def config() -> ArchConfig:
    return ArchConfig(
        name="rwkv6-7b", family="ssm", source="arXiv:2404.05892",
        d_model=4096, n_heads=64, n_kv_heads=64, head_dim=64,
        d_ff=14336, vocab=65536,
        pattern=(_LAYER,), repeats=32,
        pos_embed="none", rwkv_head_size=64,
        supports_long_context=True,
    )


def reduced() -> ArchConfig:
    return ArchConfig(
        name="rwkv6-7b-reduced", family="ssm", source="smoke",
        d_model=256, n_heads=4, n_kv_heads=4, head_dim=64,
        d_ff=512, vocab=1024,
        pattern=(_LAYER,), repeats=2,
        pos_embed="none", rwkv_head_size=64,
        supports_long_context=True,
    )
