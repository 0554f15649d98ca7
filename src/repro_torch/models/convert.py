"""Weight bridge: the reference's parameter tree → the port's.

The reference (``repro.models.decoder.init_model``) returns a pytree:
``embed``, ``final_norm``, optional ``lm_head``, ``pos`` and ``encoder``
and ``blocks`` — a tuple over the pattern whose leaves are stacked on a
leading ``repeats`` axis.
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
    the config: the embedding, the head, learned positions, the encoder
    and every pattern position's MoE, Mamba, RWKV and cross-attention
    leaves."""
    dev = resolve_device(device)
    vp, d = cfg.padded_vocab, cfg.d_model
    if tuple(np.shape(np_params["embed"])) != (vp, d):
        raise ValueError(f"embed has shape {np.shape(np_params['embed'])}, "
                         f"{cfg.name} needs {(vp, d)}")
    if ("lm_head" in np_params) == cfg.tie_embeddings:
        raise ValueError(f"{cfg.name}: lm_head present={'lm_head' in np_params}"
                         f" but tie_embeddings={cfg.tie_embeddings}")
    _check_leaves(cfg, "pos", np_params.get("pos"),
                  (cfg.max_position, d) if cfg.pos_embed == "learned"
                  else None)
    blocks = np_params["blocks"]
    if len(blocks) != len(cfg.pattern):
        raise ValueError(f"{len(blocks)} pattern blocks, {cfg.name} has "
                         f"{len(cfg.pattern)}")
    for blk, spec in zip(blocks, cfg.pattern):
        lead = _lead(blk)
        if lead != cfg.repeats:
            raise ValueError(f"blocks stacked over {lead} repeats, "
                             f"{cfg.name} has {cfg.repeats}")
        if spec.ffn == "moe":
            _check_moe(blk.get("ffn"), cfg)
        for key, want in _layer_leaves(cfg, spec, cfg.repeats).items():
            _check_leaves(cfg, key, blk.get(key), want)
    enc = np_params.get("encoder")
    if (enc is None) != (cfg.encoder is None):
        raise ValueError(f"{cfg.name}: encoder present={enc is not None} but "
                         f"the config has encoder={cfg.encoder}")
    if enc is not None:
        n = cfg.encoder.num_layers
        lead = _lead(enc["blocks"])
        if lead != n:
            raise ValueError(f"encoder blocks stacked over {lead} layers, "
                             f"{cfg.name} has {n}")
        _check_leaves(cfg, "encoder pos", enc.get("pos"),
                      (cfg.encoder.frames, d))
        _check_leaves(cfg, "encoder mixer", enc["blocks"].get("mixer"),
                      _attention_leaves(cfg, n))
    return _convert(dict(np_params), dev, dtype)


def _lead(block) -> int:
    """The stacking axis of a block: the leading dim of its first norm's
    leaf (a LayerNorm's ``w`` or an RMSNorm's weight)."""
    norm = block["norm1"]
    return np.shape(norm["w"] if isinstance(norm, dict) else norm)[0]


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    return tuple(np.shape(tree))


def _check_leaves(cfg: ArchConfig, what: str, tree, want) -> None:
    """``tree``'s leaf shapes (None when absent) against ``want``."""
    got = None if tree is None else _shapes(tree)
    if got != want:
        raise ValueError(f"{cfg.name}: {what} leaves {got}, the config "
                         f"needs {want}")


def _attention_leaves(cfg: ArchConfig, R: int) -> dict:
    d, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    return {"wq": (R, d, H * hd), "wk": (R, d, KV * hd),
            "wv": (R, d, KV * hd), "wo": (R, H * hd, d)}


def _layer_leaves(cfg: ArchConfig, spec, R: int) -> dict:
    """The expected shapes of one pattern position's Mamba, RWKV,
    channel-mix and cross-attention subtrees (``nn.mamba.init_mamba``,
    ``nn.rwkv.init_time_mix`` / ``init_channel_mix``, the second
    attention of ``attn+cross``), stacked over ``R`` repeats."""
    d = cfg.d_model
    want: dict = {}
    if spec.mixer == "attn+cross":
        want["cross"] = _attention_leaves(cfg, R)
    elif spec.mixer == "mamba":
        din, N = cfg.mamba_expand * d, cfg.mamba_d_state
        r = max(1, d // 16)
        want["mixer"] = {
            "in_proj": (R, d, 2 * din), "conv_w": (R, cfg.mamba_d_conv, din),
            "conv_b": (R, din), "x_proj": (R, din, r + 2 * N),
            "dt_proj": (R, r, din), "dt_bias": (R, din),
            "A_log": (R, din, N), "D": (R, din), "out_proj": (R, din, d)}
    elif spec.mixer == "rwkv":
        hs = cfg.rwkv_head_size
        want["mixer"] = {
            "mu": (R, 5, d),
            "mix_lora": {"a": (R, d, 32), "b": (R, 32, 5 * d)},
            **{w: (R, d, d) for w in ("wr", "wk", "wv", "wg", "wo")},
            "decay_base": (R, d),
            "decay_lora": {"a": (R, d, 64), "b": (R, 64, d)},
            "u": (R, d // hs, hs), "ln_x": (R, d)}
    if spec.ffn == "channel_mix":
        want["ffn"] = {"mu_k": (R, d), "mu_r": (R, d),
                       "wk": (R, d, cfg.d_ff), "wv": (R, cfg.d_ff, d),
                       "wr": (R, d, d)}
    return want


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
