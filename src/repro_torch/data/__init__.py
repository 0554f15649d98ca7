"""Training data: synthetic token batches, background prefetch and the
parameter-tiering monitor (port of ``repro.data``)."""

from repro_torch.data.cache import AccessMonitor, Tier, TierThresholds
from repro_torch.data.pipeline import PrefetchLoader, SyntheticTokenDataset

__all__ = ["AccessMonitor", "PrefetchLoader", "SyntheticTokenDataset",
           "Tier", "TierThresholds"]
