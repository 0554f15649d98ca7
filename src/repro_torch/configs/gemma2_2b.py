"""gemma2-2b [dense] — 26L d_model=2304 8H (GQA kv=4) d_ff=9216
vocab=256000 — local+global alternating attention, logit softcap
[arXiv:2408.00118].
"""

from repro_torch.models.config import ArchConfig, LayerSpec

_LOCAL = LayerSpec(mixer="attn", ffn="dense", window=4096,
                   logit_softcap=50.0, post_norm=True)
_GLOBAL = LayerSpec(mixer="attn", ffn="dense",
                    logit_softcap=50.0, post_norm=True)


def config() -> ArchConfig:
    return ArchConfig(
        name="gemma2-2b", family="dense", source="arXiv:2408.00118",
        d_model=2304, n_heads=8, n_kv_heads=4, head_dim=256,
        d_ff=9216, vocab=256000,
        pattern=(_LOCAL, _GLOBAL), repeats=13,
        tie_embeddings=True, embed_scale=True, final_softcap=30.0,
        supports_long_context=True,
    )


def reduced() -> ArchConfig:
    return ArchConfig(
        name="gemma2-2b-reduced", family="dense", source="smoke",
        d_model=256, n_heads=4, n_kv_heads=2, head_dim=64,
        d_ff=512, vocab=1024,
        pattern=(
            LayerSpec(mixer="attn", ffn="dense", window=32,
                      logit_softcap=50.0, post_norm=True),
            _GLOBAL,
        ),
        repeats=1,
        tie_embeddings=True, embed_scale=True, final_softcap=30.0,
        supports_long_context=True,
    )
