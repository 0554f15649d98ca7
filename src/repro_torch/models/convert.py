"""Weight bridge: the reference's parameter tree → the port's.

The reference (``repro.models.decoder.init_model``) returns a pytree:
``embed``, ``final_norm``, optional ``lm_head`` and ``blocks`` — a tuple
over the pattern whose leaves are stacked on a leading ``repeats`` axis.
The port keeps the same tree, so conversion is leaf by leaf.  The input
is that tree with every leaf already a numpy array (e.g.
``jax.tree.map(np.asarray, params)``); this module imports neither jax
nor the reference package.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.config import ArchConfig


def _convert(tree, device, dtype):
    if isinstance(tree, dict):
        return {k: _convert(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_convert(v, device, dtype) for v in tree)
    arr = np.asarray(tree)
    t = torch.from_numpy(np.array(arr, copy=True))   # owns writable memory
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def params_from_jax(np_params, cfg: ArchConfig, *, device=None,
                    dtype: torch.dtype | None = None):
    """Convert the reference's parameter tree (numpy leaves) for ``cfg``
    into the port's tensors on ``device`` (default ``cuda``), optionally
    casting float leaves to ``dtype``.  Checks the tree's shapes against
    the config."""
    dev = resolve_device(device)
    vp, d = cfg.padded_vocab, cfg.d_model
    if tuple(np.shape(np_params["embed"])) != (vp, d):
        raise ValueError(f"embed has shape {np.shape(np_params['embed'])}, "
                         f"{cfg.name} needs {(vp, d)}")
    if ("lm_head" in np_params) == cfg.tie_embeddings:
        raise ValueError(f"{cfg.name}: lm_head present={'lm_head' in np_params}"
                         f" but tie_embeddings={cfg.tie_embeddings}")
    blocks = np_params["blocks"]
    if len(blocks) != len(cfg.pattern):
        raise ValueError(f"{len(blocks)} pattern blocks, {cfg.name} has "
                         f"{len(cfg.pattern)}")
    for blk, spec in zip(blocks, cfg.pattern):
        lead = np.shape(blk["norm1"])[0]
        if lead != cfg.repeats:
            raise ValueError(f"blocks stacked over {lead} repeats, "
                             f"{cfg.name} has {cfg.repeats}")
        if spec.ffn == "moe":
            _check_moe(blk.get("ffn"), cfg)
    return _convert(dict(np_params), dev, dtype)


def _check_moe(ffn, cfg: ArchConfig) -> None:
    """The MoE leaves of one pattern position against the config:
    router (R, d, E), w1/w3 (R, E, d, f), w2 (R, E, f, d)."""
    R, d, E = cfg.repeats, cfg.d_model, cfg.moe_experts
    f = cfg.moe_d_ff or cfg.d_ff
    want = {"router": (R, d, E), "w1": (R, E, d, f), "w3": (R, E, d, f),
            "w2": (R, E, f, d)}
    got = ({k: tuple(np.shape(v)) for k, v in ffn.items()}
           if isinstance(ffn, dict) else None)
    if got != want:
        raise ValueError(f"{cfg.name}: MoE ffn leaves {got}, the config "
                         f"needs {want}")
