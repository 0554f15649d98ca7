"""llama3.2-1b [dense] — 16L d_model=2048 32H (GQA kv=8) d_ff=8192
vocab=128256 [hf:meta-llama/Llama-3.2-1B]."""

from repro_torch.models.config import ArchConfig, LayerSpec

_LAYER = LayerSpec(mixer="attn", ffn="dense")


def config() -> ArchConfig:
    return ArchConfig(
        name="llama3.2-1b", family="dense",
        source="hf:meta-llama/Llama-3.2-1B",
        d_model=2048, n_heads=32, n_kv_heads=8, head_dim=64,
        d_ff=8192, vocab=128256,
        pattern=(_LAYER,), repeats=16,
        rope_theta=500000.0, tie_embeddings=True,
    )


def reduced() -> ArchConfig:
    return ArchConfig(
        name="llama3.2-1b-reduced", family="dense", source="smoke",
        d_model=256, n_heads=8, n_kv_heads=2, head_dim=32,
        d_ff=512, vocab=1024,
        pattern=(_LAYER,), repeats=2,
        rope_theta=500000.0, tie_embeddings=True,
    )
