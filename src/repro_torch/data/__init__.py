"""Training data: synthetic token batches and background prefetch (port
of the token half of ``repro.data``)."""

from repro_torch.data.pipeline import PrefetchLoader, SyntheticTokenDataset

__all__ = ["PrefetchLoader", "SyntheticTokenDataset"]
