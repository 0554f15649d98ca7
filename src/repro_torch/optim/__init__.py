"""Optimizers on trees of tensors (port of ``repro.optim``)."""

from repro_torch.optim.optimizers import (
    OptState,
    adamw_init,
    adamw_update,
    clip_by_global_norm,
    sgd_update,
)

__all__ = [
    "OptState", "adamw_init", "adamw_update", "clip_by_global_norm",
    "sgd_update",
]
