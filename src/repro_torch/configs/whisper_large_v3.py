"""whisper-large-v3 [audio] — 32L d_model=1280 20H d_ff=5120 vocab=51866 —
encoder-decoder, conv frontend STUB [arXiv:2212.04356].

Backbone only, as in the reference: the mel-spectrogram + conv feature
extractor is a stub — callers pass precomputed frame embeddings (B, 1500,
1280) as ``context``.  32 bidirectional encoder layers + 32 decoder
layers (self-attn + cross-attn).  Learned positions, LayerNorm, no RoPE.
Decode reads a fixed cross-KV cache.
"""

from repro_torch.models.config import ArchConfig, EncoderConfig, LayerSpec

_DEC = LayerSpec(mixer="attn+cross", ffn="dense", rope=False)


def config() -> ArchConfig:
    return ArchConfig(
        name="whisper-large-v3", family="audio", source="arXiv:2212.04356",
        d_model=1280, n_heads=20, n_kv_heads=20, head_dim=64,
        d_ff=5120, vocab=51866,
        pattern=(_DEC,), repeats=32,
        pos_embed="learned", max_position=32768, norm="ln",
        encoder=EncoderConfig(num_layers=32, frames=1500),
        cross_kv_len=1500, tie_embeddings=True,
    )


def reduced() -> ArchConfig:
    return ArchConfig(
        name="whisper-large-v3-reduced", family="audio", source="smoke",
        d_model=256, n_heads=4, n_kv_heads=4, head_dim=64,
        d_ff=512, vocab=1024,
        pattern=(_DEC,), repeats=2,
        pos_embed="learned", max_position=512, norm="ln",
        encoder=EncoderConfig(num_layers=2, frames=64),
        cross_kv_len=64, tie_embeddings=True,
    )
