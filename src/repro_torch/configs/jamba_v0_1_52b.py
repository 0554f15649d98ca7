"""jamba-v0.1-52b [hybrid] — 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=65536, MoE 16e top-2 — Mamba+attention 1:7 interleave, MoE every
2nd layer [arXiv:2403.19887].

Jamba block structure: 8-layer period with ONE attention layer (index 3)
and seven Mamba layers; MoE replaces the dense FFN on every second layer.
No positional embeddings (Mamba carries position).  Runs ``long_500k``:
only 4 attention layers hold KV caches; everything else is O(1) state.
"""

from repro_torch.models.config import ArchConfig, LayerSpec


def _pattern() -> tuple[LayerSpec, ...]:
    specs = []
    for i in range(8):
        mixer = "attn" if i == 3 else "mamba"
        ffn = "moe" if i % 2 == 1 else "dense"
        specs.append(LayerSpec(mixer=mixer, ffn=ffn, rope=False))
    return tuple(specs)


def config() -> ArchConfig:
    return ArchConfig(
        name="jamba-v0.1-52b", family="hybrid", source="arXiv:2403.19887",
        d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
        d_ff=14336, vocab=65536,
        pattern=_pattern(), repeats=4,
        moe_experts=16, moe_top_k=2, moe_d_ff=14336,
        pos_embed="none",
        mamba_d_state=16, mamba_d_conv=4, mamba_expand=2,
        supports_long_context=True,
        train_microbatch=16,  # the reference's: 8192-wide mamba activations
    )


def reduced() -> ArchConfig:
    return ArchConfig(
        name="jamba-v0.1-52b-reduced", family="hybrid", source="smoke",
        d_model=256, n_heads=4, n_kv_heads=2, head_dim=64,
        d_ff=512, vocab=1024,
        pattern=(
            LayerSpec(mixer="mamba", ffn="dense", rope=False),
            LayerSpec(mixer="attn", ffn="moe", rope=False),
        ),
        repeats=1,
        moe_experts=4, moe_top_k=2, moe_d_ff=512,
        pos_embed="none",
        supports_long_context=True,
    )
