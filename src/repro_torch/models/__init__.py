"""Model configs, the decoder and the weight bridge from the reference."""

from repro_torch.models.config import ArchConfig, EncoderConfig, LayerSpec

__all__ = ["ArchConfig", "EncoderConfig", "LayerSpec"]
