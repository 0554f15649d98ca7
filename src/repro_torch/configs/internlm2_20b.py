"""internlm2-20b [dense] — 48L d_model=6144 48H (GQA kv=8) d_ff=16384
vocab=92544 — GQA [arXiv:2403.17297]."""

from repro_torch.models.config import ArchConfig, LayerSpec

_LAYER = LayerSpec(mixer="attn", ffn="dense")


def config() -> ArchConfig:
    return ArchConfig(
        name="internlm2-20b", family="dense", source="arXiv:2403.17297",
        d_model=6144, n_heads=48, n_kv_heads=8, head_dim=128,
        d_ff=16384, vocab=92544,
        pattern=(_LAYER,), repeats=48,
        rope_theta=1000000.0,
    )


def reduced() -> ArchConfig:
    return ArchConfig(
        name="internlm2-20b-reduced", family="dense", source="smoke",
        d_model=384, n_heads=6, n_kv_heads=2, head_dim=64,
        d_ff=512, vocab=1024,
        pattern=(_LAYER,), repeats=2,
        rope_theta=1000000.0,
    )
