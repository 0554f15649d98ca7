"""Block-pattern decoder: init, forward, loss, prefill, decode (port of
``repro.models.decoder``) for every mixer of the reference — attention,
cross-attention, attention + cross (whisper's decoder), Mamba and RWKV-6 —
with dense, MoE or channel-mix FFNs, learned or rotary positions, and the
whisper-style bidirectional encoder.

Parameters keep the reference's tree: ``embed``, ``final_norm``,
optional ``lm_head`` and ``pos`` (learned positions), optional
``encoder`` (``blocks`` stacked over its layers, ``final_norm``, ``pos``)
and ``blocks`` — a tuple over the pattern whose leaves are stacked on a
leading ``repeats`` axis — with weights ``(d_in, d_out)`` used as
``x @ w``.  Layer ``r`` of pattern position ``j`` is the view
``blocks[j][...][r]``.

Entry points:
  * :func:`init_model`  — parameter tree from a seeded ``torch.Generator``
  * :func:`forward`     — full-sequence logits (+ MoE aux loss)
  * :func:`loss_fn`     — token cross-entropy (+ MoE aux loss), the
    training objective
  * :func:`init_cache`  — decode cache (paged page pool or dense rings,
    per-slot recurrent state and cross k/v)
  * :func:`prefill`     — one forward that fills the cache
  * :func:`decode_step` — one-token step against the cache
  * :func:`decode_loop` — ``steps`` decode steps, tokens kept on device

Caches are updated in place (the new k/v and recurrent states land in the
caller's tensors); functions still return the cache dict so call sites
read like the reference's.

Cross-attention is non-causal on every path, where the reference's
training path masks context frame j from query t whenever j > t
(ROADMAP.md R7).  Serving keeps the reference's zero cross k/v: nothing
fills ``ck``/``cv`` (R6), so a cross layer adds exactly 0 when serving.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.kernels import paged_attention as paged_k
from repro_torch.models.config import ArchConfig, LayerSpec
from repro_torch.nn import attention as attn_mod
from repro_torch.nn import mamba as mamba_mod
from repro_torch.nn import moe as moe_mod
from repro_torch.nn import rwkv as rwkv_mod
from repro_torch.nn.attention import AttnSpec
from repro_torch.nn.base import layernorm, masked_nll, rmsnorm, softcap
from repro_torch.obs.trace import span
from repro_torch.parallel import act
from repro_torch.tree import tree_map as _tree_map

#: the whisper encoder's layer: bidirectional self-attention, dense FFN
ENCODER_LAYER = LayerSpec(mixer="attn", ffn="dense", rope=False)


def _attn_spec(cfg: ArchConfig, spec: LayerSpec, *, causal=True) -> AttnSpec:
    return AttnSpec(
        n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads, head_dim=cfg.head_dim,
        causal=causal, window=spec.window, logit_softcap=spec.logit_softcap,
        rope=spec.rope and cfg.pos_embed == "rope",
        rope_theta=cfg.rope_theta, rope_fraction=spec.rope_fraction,
        qk_norm=spec.qk_norm, impl=cfg.attn_impl,
    )


def _cross_spec(cfg: ArchConfig, spec: LayerSpec) -> AttnSpec:
    """Cross-attention attends every context frame: non-causal, no
    window (the reference's ``attention_with_kv`` and cross decode)."""
    return dataclasses.replace(_attn_spec(cfg, spec), causal=False,
                               window=None)


def _norm_init(cfg: ArchConfig, d: int, device, dtype):
    if cfg.norm == "rms":
        return torch.ones(d, device=device, dtype=dtype)
    return {"w": torch.ones(d, device=device, dtype=dtype),
            "b": torch.zeros(d, device=device, dtype=dtype)}


def _norm(cfg: ArchConfig, p, x):
    return rmsnorm(x, p) if cfg.norm == "rms" else layernorm(x, p)


def _cast(p, dtype):
    """Float parameters in the compute dtype (a no-op when they already
    are); norms recompute in f32 internally."""
    return _tree_map(lambda a: a.to(dtype) if a.is_floating_point() else a, p)


# --------------------------------------------------------------------------
# init
# --------------------------------------------------------------------------


def _init_layer(gen, cfg: ArchConfig, spec: LayerSpec, device, dtype):
    d = cfg.d_model
    p: dict[str, Any] = {"norm1": _norm_init(cfg, d, device, dtype)}
    if spec.mixer in ("attn", "cross_attn", "attn+cross"):
        p["mixer"] = attn_mod.init_attention(gen, d, _attn_spec(cfg, spec),
                                             device=device, dtype=dtype)
        if spec.mixer == "attn+cross":
            p["norm_cross"] = _norm_init(cfg, d, device, dtype)
            p["cross"] = attn_mod.init_attention(
                gen, d, _attn_spec(cfg, spec), device=device, dtype=dtype)
    elif spec.mixer == "mamba":
        p["mixer"] = mamba_mod.init_mamba(
            gen, d, d_state=cfg.mamba_d_state, d_conv=cfg.mamba_d_conv,
            expand=cfg.mamba_expand, device=device, dtype=dtype)
    elif spec.mixer == "rwkv":
        p["mixer"] = rwkv_mod.init_time_mix(
            gen, d, head_size=cfg.rwkv_head_size, device=device, dtype=dtype)
    else:
        raise ValueError(f"unknown mixer {spec.mixer!r}")
    if spec.ffn != "none":
        p["norm2"] = _norm_init(cfg, d, device, dtype)
    if spec.ffn == "dense":
        p["ffn"] = moe_mod.init_dense_ffn(gen, d, cfg.d_ff, device=device,
                                          dtype=dtype)
    elif spec.ffn == "moe":
        p["ffn"] = moe_mod.init_moe(gen, d, cfg.moe_d_ff or cfg.d_ff,
                                    cfg.moe_experts, device=device,
                                    dtype=dtype)
    elif spec.ffn == "channel_mix":
        p["ffn"] = rwkv_mod.init_channel_mix(gen, d, cfg.d_ff, device=device,
                                             dtype=dtype)
    if spec.post_norm:
        p["norm_post1"] = _norm_init(cfg, d, device, dtype)
        if spec.ffn != "none":
            p["norm_post2"] = _norm_init(cfg, d, device, dtype)
    return p


def init_model(cfg: ArchConfig, *, seed: int = 0, device=None,
               dtype=torch.float32):
    """Random parameters with the reference's distributions and scales
    (embedding and head N(0, 1/d_model), learned positions N(0, 0.02²),
    each mixer and FFN as its ``nn`` module's init, norms 1), drawn layer
    by layer from a ``torch.Generator`` seeded with ``seed`` on
    ``device``.  Each layer is copied into its slot of the stacked leaves
    as it is drawn, so the peak is the stacked tree plus one layer
    (OLMoE-1B-7B's expert weights are 27 GB in float32).
    The draws differ from ``jax.random``'s: parity tests convert the
    reference's weights with :func:`repro_torch.models.convert.params_from_jax`.
    """
    cfg.validate()
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    d, vp = cfg.d_model, cfg.padded_vocab
    s = 1.0 / math.sqrt(d)

    def normal(shape, scale):
        return torch.randn(shape, generator=gen, device=dev,
                           dtype=dtype).mul_(scale)

    params: dict[str, Any] = {
        "embed": normal((vp, d), s),
        "final_norm": _norm_init(cfg, d, dev, dtype),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = normal((d, vp), s)
    if cfg.pos_embed == "learned":
        params["pos"] = normal((cfg.max_position, d), 0.02)
    params["blocks"] = tuple(
        _init_stacked(gen, cfg, spec, cfg.repeats, dev, dtype)
        for spec in cfg.pattern)
    if cfg.encoder is not None:
        params["encoder"] = {
            "blocks": _init_stacked(gen, cfg, ENCODER_LAYER,
                                    cfg.encoder.num_layers, dev, dtype),
            "final_norm": _norm_init(cfg, d, dev, dtype),
            "pos": normal((cfg.encoder.frames, d), 0.02),
        }
    return params


def _init_stacked(gen, cfg: ArchConfig, spec: LayerSpec, n: int, device,
                  dtype):
    """``n`` layers of ``spec`` stacked on a leading axis, each drawn and
    copied into place in turn."""
    first = _init_layer(gen, cfg, spec, device, dtype)
    out = _tree_map(lambda a: a.new_empty((n, *a.shape)), first)
    for r in range(n):
        layer = first if r == 0 else _init_layer(gen, cfg, spec, device,
                                                 dtype)
        _copy_into(out, layer, r)
    return out


def _copy_into(dst, src, r: int) -> None:
    if isinstance(dst, dict):
        for k in dst:
            _copy_into(dst[k], src[k], r)
    else:
        dst[r].copy_(src)


# --------------------------------------------------------------------------
# caches
# --------------------------------------------------------------------------


def _layer_cache(cfg: ArchConfig, spec: LayerSpec, batch: int,
                 cache_len: int, dtype, device, *, pool=None):
    """One layer's decode cache: the self-attention's ring buffers (or
    its share of the page pool when ``pool = (num_pages, page_size)``),
    the cross k/v ``ck``/``cv`` (batch, cross_kv_len, KV, hd), the Mamba
    state ``h``/``conv`` or the RWKV state ``state``/``tm_shift``/
    ``cm_shift`` — per slot, whatever the layout of the self-attention."""
    c: dict[str, Any] = {}
    if spec.mixer in ("attn", "attn+cross"):
        aspec = _attn_spec(cfg, spec)
        if pool is not None:
            c.update(attn_mod.init_paged_kv_cache(*pool, aspec, dtype,
                                                  device=device))
        else:
            L = cache_len if spec.window is None else min(cache_len,
                                                          spec.window)
            c.update(attn_mod.init_kv_cache(batch, L, aspec, dtype,
                                            device=device))
    if spec.mixer in ("cross_attn", "attn+cross"):
        shape = (batch, cfg.cross_kv_len, cfg.n_kv_heads, cfg.head_dim)
        c["ck"] = torch.zeros(shape, dtype=dtype, device=device)
        c["cv"] = torch.zeros(shape, dtype=dtype, device=device)
    if spec.mixer == "mamba":
        c.update(mamba_mod.init_mamba_cache(
            batch, cfg.d_model, d_state=cfg.mamba_d_state,
            d_conv=cfg.mamba_d_conv, expand=cfg.mamba_expand, dtype=dtype,
            device=device))
    if spec.mixer == "rwkv":
        c.update(rwkv_mod.init_rwkv_cache(
            batch, cfg.d_model, head_size=cfg.rwkv_head_size, device=device))
    return c


#: the per-sequence leaves a slot view slices (everything but the pools)
_POOL_KEYS = ("kp", "vp")


def init_cache(cfg: ArchConfig, batch: int, cache_len: int,
               dtype=torch.bfloat16, *, global_cap: int | None = None,
               page_size: int = 16, num_pages: int | None = None,
               device=None):
    """Decode cache, stacked (repeats, …) per pattern position.

    ``global_cap`` bounds the KV length of full-attention layers (no
    window; gemma2's global layers at ``long_500k``, passed by
    :mod:`repro_torch.launch.specs`).

    Dense (``cfg.kv_impl == "dense"``): a tuple over the pattern of each
    layer's cache: ``{"k", "v", "pos"}`` ring buffers (window-capped
    length) for self-attention, ``{"ck", "cv"}`` for cross-attention,
    ``{"h", "conv"}`` for Mamba, ``{"state", "tm_shift", "cm_shift"}``
    for RWKV.

    Paged: ``{"layers", "page_table", "length", "active"}`` — the
    self-attention layers hold ``{"kp", "vp"}`` page pools of
    ``num_pages`` pages (default: enough for every slot,
    identity-allocated: slot b owns pages ``[1 + b·P, 1 + (b+1)·P)``);
    below full coverage the table starts at the scratch page and the host
    :class:`~repro_torch.kernels.PagePool` assigns it.  Cross k/v and
    recurrent states stay per slot, (repeats, batch, …).  ``length``
    carries per-sequence positions and ``active`` masks live slots."""
    dev = resolve_device(device)
    paged = cfg.kv_impl == "paged"
    pages_per_seq = -(-cache_len // page_size)
    if paged and num_pages is None:
        num_pages = 1 + batch * pages_per_seq
    R = cfg.repeats
    caches = []
    for spec in cfg.pattern:
        L = cache_len
        if (global_cap is not None and spec.mixer == "attn"
                and spec.window is None):
            L = min(L, global_cap)
        one = _layer_cache(cfg, spec, batch, L, dtype, dev,
                           pool=(num_pages, page_size) if paged else None)
        caches.append({k: v[None].repeat(R, *([1] * v.dim()))
                       for k, v in one.items()})
    if not paged:
        return tuple(caches)
    if num_pages >= 1 + batch * pages_per_seq:
        table = 1 + torch.arange(batch * pages_per_seq, dtype=torch.int32,
                                 device=dev).reshape(batch, pages_per_seq)
    else:
        table = torch.zeros((batch, pages_per_seq), dtype=torch.int32,
                            device=dev)
    return {
        "layers": tuple(caches),
        "page_table": table,
        "length": torch.zeros(batch, dtype=torch.int32, device=dev),
        "active": torch.ones(batch, dtype=torch.bool, device=dev),
    }


# --------------------------------------------------------------------------
# layers
# --------------------------------------------------------------------------


def _ffn_block(cfg, spec: LayerSpec, p, x, *, mode: str = "seq", cache=None,
               with_aux: bool = False):
    """norm2 → FFN → (post-norm) → residual, shared by the training,
    prefill and decode layers.  The MoE routes each sequence as one group
    (prefill: S tokens; decode: 1) through ``cfg.moe_impl``.  ``mode``:
    "seq" (training / forward), "prefill" (also writes the channel-mix's
    shift state into ``cache``) or "decode" (steps the channel-mix
    against ``cache``, in place).  Returns ``(x, aux)``: ``aux`` is the
    MoE's load-balance loss when ``with_aux`` (training) and the FFN is
    an MoE, else ``None`` — serving never computes it."""
    if spec.ffn == "none":
        return x, None
    h = _norm(cfg, p["norm2"], x)
    aux = None
    if spec.ffn == "moe" and with_aux:
        y, terms = moe_mod.moe_ffn(p["ffn"], h, top_k=cfg.moe_top_k,
                                   capacity_factor=cfg.moe_capacity_factor,
                                   impl=cfg.moe_impl)
        aux = terms["aux_loss"]
    elif spec.ffn == "moe":
        y = moe_mod.moe_forward(p["ffn"], h, top_k=cfg.moe_top_k,
                                capacity_factor=cfg.moe_capacity_factor,
                                impl=cfg.moe_impl)
    elif spec.ffn == "channel_mix":
        if mode == "decode":
            y, _ = rwkv_mod.decode_channel_mix(p["ffn"], h, cache)
        else:
            y = rwkv_mod.channel_mix_seq(p["ffn"], h)
            if mode == "prefill":
                cache["cm_shift"].copy_(h[:, -1])
    else:
        y = moe_mod.dense_ffn(p["ffn"], h)
    if spec.post_norm:
        y = _norm(cfg, p["norm_post2"], y)
    return x + y, aux


def _copy_state(cache, state: dict) -> None:
    """Write a recurrent mixer's state into the cache's tensors."""
    for k, v in state.items():
        cache[k].copy_(v)


def _decode_layer(cfg, spec: LayerSpec, p, x, cache, index, *, paged=None,
                  impl: str = "auto"):
    """One decode layer, its cache updated in place.  ``paged =
    (page_table, q_pos, active)`` routes the self-attention through the
    shared page pool (ragged per-sequence positions) and gives the
    ``attn+cross`` decode its per-slot positions; ``None`` keeps the dense
    ring-buffer path (one ``index``)."""
    p = act.gather_params(_cast(p, x.dtype), cfg)
    aspec = _attn_spec(cfg, spec)
    h = _norm(cfg, p["norm1"], x)
    if spec.mixer in ("attn", "attn+cross"):
        if paged is not None:
            pt, q_pos, active = paged
            y, _ = attn_mod.paged_decode_attention(
                p["mixer"], h, cache, pt, q_pos, aspec, active=active,
                impl=impl)
            cross_index = q_pos
        else:
            y, _ = attn_mod.decode_attention(p["mixer"], h, cache, index,
                                             aspec)
            cross_index = index
        if spec.mixer == "attn+cross":
            x = x + y
            h = _norm(cfg, p["norm_cross"], x)
            y, _ = attn_mod.decode_attention(
                p["cross"], h, {"k": cache["ck"], "v": cache["cv"]},
                cross_index, _cross_spec(cfg, spec), cross=True)
    elif spec.mixer == "cross_attn":
        y, _ = attn_mod.decode_attention(
            p["mixer"], h, {"k": cache["ck"], "v": cache["cv"]}, index,
            _cross_spec(cfg, spec), cross=True)
    elif spec.mixer == "mamba":
        y, _ = mamba_mod.decode_mamba(p["mixer"], h, cache,
                                      d_state=cfg.mamba_d_state,
                                      d_conv=cfg.mamba_d_conv)
    else:
        y, _ = rwkv_mod.decode_time_mix(p["mixer"], h, cache,
                                        head_size=cfg.rwkv_head_size)
    if spec.post_norm and spec.mixer != "attn+cross":
        y = _norm(cfg, p["norm_post1"], y)
    return _ffn_block(cfg, spec, p, x + y, mode="decode", cache=cache)[0]


def _embed(params, cfg: ArchConfig, tokens, compute_dtype):
    x = act.embed_lookup(params["embed"], tokens.long()).to(compute_dtype)
    if cfg.embed_scale:
        x = x * math.sqrt(cfg.d_model)
    return x


def _head_weight(params, cfg: ArchConfig, compute_dtype):
    """(D, padded_vocab): the tied embedding's transpose or ``lm_head``."""
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return head.to(compute_dtype)


def _logits(params, cfg: ArchConfig, x, compute_dtype, *, shard=False):
    """Head and final soft-cap of normed hidden states; ``shard`` lays
    the logits out batch × vocab on an active mesh (the full-sequence
    forward's)."""
    logits = x @ _head_weight(params, cfg, compute_dtype)
    if shard:
        logits = act.shard_logits(logits)
    if cfg.final_softcap:
        logits = softcap(logits.float(), cfg.final_softcap)
    return logits


def _head(params, cfg: ArchConfig, x, compute_dtype):
    """Final norm, head and final soft-cap."""
    return _logits(params, cfg, _norm(cfg, params["final_norm"], x),
                   compute_dtype)


def _layer_views(tree, r: int):
    return _tree_map(lambda a: a[r], tree)


def _arange_positions(B: int, S: int, device):
    return torch.arange(S, dtype=torch.int32, device=device).expand(B, S)


# --------------------------------------------------------------------------
# forward (training)
# --------------------------------------------------------------------------


def _apply_layer(cfg, spec: LayerSpec, p, x, *, positions, layer: int,
                 cross_kv=None, causal=True):
    """One training / encoder layer: the mixer (attention through the
    flash kernels, ``cfg.attn_impl``; cross-attention non-causal over
    ``cross_kv`` (B, N, D)) then the FFN, in the device-timed spans
    ``layer.mixer`` and ``layer.ffn`` (args ``layer``, the index, and
    ``kind``).  Returns (x, moe_aux) with moe_aux a float32 scalar
    tensor."""
    p = act.gather_params(_cast(p, x.dtype), cfg)
    with span("layer.mixer", "model", layer=layer, kind=spec.mixer):
        x = _mixer_block(cfg, spec, p, x, positions=positions,
                         cross_kv=cross_kv, causal=causal)
    with span("layer.ffn", "model", layer=layer, kind=spec.ffn):
        x, aux = _ffn_block(cfg, spec, p, x, with_aux=True)
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x, aux


def _mixer_block(cfg, spec: LayerSpec, p, x, *, positions, cross_kv,
                 causal):
    """norm1 → the training layer's mixer → (post-norm) → residual (an
    ``attn+cross`` layer: its self-attention, then the cross-attention,
    each with its residual)."""
    h = _norm(cfg, p["norm1"], x)
    if spec.mixer in ("cross_attn", "attn+cross"):
        kv_pos = _arange_positions(*cross_kv.shape[:2], x.device)
        kv_x = cross_kv.to(h.dtype)
    if spec.mixer in ("attn", "attn+cross"):
        y = attn_mod.attention(p["mixer"], h,
                               _attn_spec(cfg, spec, causal=causal),
                               positions=positions)
        if spec.mixer == "attn+cross":
            if spec.post_norm:
                y = _norm(cfg, p["norm_post1"], y)
            x = x + y
            h = _norm(cfg, p["norm_cross"], x)
            y = attn_mod.attention(p["cross"], h, _cross_spec(cfg, spec),
                                   positions=positions, kv_x=kv_x,
                                   kv_positions=kv_pos)
    elif spec.mixer == "cross_attn":
        y = attn_mod.attention(p["mixer"], h, _cross_spec(cfg, spec),
                               positions=positions, kv_x=kv_x,
                               kv_positions=kv_pos)
    elif spec.mixer == "mamba":
        y = mamba_mod.mamba(p["mixer"], h, d_state=cfg.mamba_d_state,
                            d_conv=cfg.mamba_d_conv)
    else:
        y = rwkv_mod.time_mix(p["mixer"], h, head_size=cfg.rwkv_head_size)
    if spec.post_norm and spec.mixer != "attn+cross":
        y = _norm(cfg, p["norm_post1"], y)
    return x + y


def _run_blocks(params, cfg: ArchConfig, x, *, positions, cross_kv=None,
                remat=True):
    """Every layer in order (a Python loop where the reference scans the
    stacked blocks).  With ``remat`` each layer is checkpointed
    (``torch.utils.checkpoint``, non-reentrant): its activations are
    recomputed, one layer at a time, in the backward pass, so the forward
    kernels of a layer, and its ``layer.*`` spans, run twice per training
    step.  Returns (x, summed moe_aux)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for r in range(cfg.repeats):
        p_r = _layer_views(params["blocks"], r)
        for j, spec in enumerate(cfg.pattern):
            def layer(x, cross_kv, _p=p_r[j], _spec=spec,
                      _i=r * len(cfg.pattern) + j):
                return _apply_layer(cfg, _spec, _p, x, positions=positions,
                                    layer=_i, cross_kv=cross_kv)

            if remat:
                x, a = checkpoint(layer, x, cross_kv, use_reentrant=False)
            else:
                x, a = layer(x, cross_kv)
            x = act.shard_batch_act(x)
            aux = aux + a
    return x, aux


def _encode(params, cfg: ArchConfig, context, *, remat=True):
    """The whisper-style bidirectional encoder over stub frame embeddings
    ``context`` (B, N, D): learned positions, ``encoder.num_layers``
    non-causal self-attention layers (each checkpointed with ``remat``),
    the final norm."""
    enc = params["encoder"]
    x = context + enc["pos"][:context.shape[1]].to(context.dtype)
    positions = _arange_positions(*x.shape[:2], x.device)
    for r in range(cfg.encoder.num_layers):
        def layer(x, _p=_layer_views(enc["blocks"], r), _r=r):
            return act.shard_batch_act(_apply_layer(
                cfg, ENCODER_LAYER, _p, x, positions=positions, layer=_r,
                causal=False)[0])

        x = checkpoint(layer, x, use_reentrant=False) if remat else layer(x)
    return _norm(cfg, enc["final_norm"], x)


def _cross_source(params, cfg: ArchConfig, context, compute_dtype, remat):
    """What the cross-attention layers attend: the encoder's output for
    an encoder arch, the stub context itself (image patches) for a
    cross-attention one, None otherwise."""
    if cfg.encoder is None and not cfg.cross_kv_len:
        return None
    if context is None:
        raise ValueError(f"{cfg.name} attends a context: pass the stub "
                         "frontend's embeddings (B, N, d_model)")
    context = context.to(compute_dtype)
    if cfg.encoder is not None:
        return _encode(params, cfg, context, remat=remat)
    return context


def _hidden(params, cfg: ArchConfig, tokens, *, context=None,
            compute_dtype=torch.bfloat16, remat=True):
    """Backbone up to the final norm.  tokens: (B, S) integer; positions
    are ``arange(S)`` per row, which the flash kernel's index masking
    relies on.  Returns (x (B, S, D), moe_aux)."""
    B, S = tokens.shape
    x = act.shard_batch_act(_embed(params, cfg, tokens, compute_dtype))
    if cfg.pos_embed == "learned":
        x = x + params["pos"][:S].to(compute_dtype)
    cross_kv = _cross_source(params, cfg, context, compute_dtype, remat)
    x, aux = _run_blocks(params, cfg, x,
                         positions=_arange_positions(B, S, tokens.device),
                         cross_kv=cross_kv, remat=remat)
    return _norm(cfg, params["final_norm"], x), aux


def forward(params, cfg: ArchConfig, tokens, *, context=None,
            compute_dtype=torch.bfloat16, remat=True):
    """tokens: (B, S); ``context``: the stub frontend's embeddings (B, N,
    D) of the audio and vision archs.  Returns (logits (B, S,
    padded_vocab), moe_aux).  The attention follows ``cfg.attn_impl``,
    the MoE ``cfg.moe_impl``."""
    x, aux = _hidden(params, cfg, tokens, context=context,
                     compute_dtype=compute_dtype, remat=remat)
    return _logits(params, cfg, x, compute_dtype, shard=True), aux


#: sequence-chunk length for the loss head: logits materialize one
#: (B, LOSS_CHUNK, vocab) tile at a time (the reference's value)
LOSS_CHUNK = 512
MOE_AUX_COEF = 0.01


def _chunk_nll(x_c, y_c, head, final_softcap):
    """Summed token NLL and token count of one sequence chunk."""
    logits = act.shard_logits(x_c @ head)
    if final_softcap:
        logits = softcap(logits.float(), final_softcap)
    return masked_nll(logits, y_c)


def loss_fn(params, cfg: ArchConfig, batch, *, compute_dtype=torch.bfloat16,
            remat=True):
    """Mean token cross-entropy of ``batch`` ({"tokens", "labels"}, (B, S)
    integer tensors; labels < 0 are ignored; and "context" for the audio
    and vision archs), plus ``MOE_AUX_COEF · aux / num_layers`` for MoE
    archs.  The head runs over chunks of ``LOSS_CHUNK`` positions (when S
    is a multiple above it), each checkpointed so its (B, chunk, vocab)
    logits are recomputed in the backward pass instead of kept; the
    forward's head and NLL are the device-timed span ``loss.head``.  The
    attention follows ``cfg.attn_impl``, the MoE ``cfg.moe_impl``."""
    x, aux = _hidden(params, cfg, batch["tokens"],
                     context=batch.get("context"),
                     compute_dtype=compute_dtype, remat=remat)
    labels = batch["labels"]
    S = x.shape[1]
    C = LOSS_CHUNK if (S % LOSS_CHUNK == 0 and S > LOSS_CHUNK) else S
    with span("loss.head", "model"):
        head = _head_weight(params, cfg, compute_dtype)
        nll = torch.zeros((), dtype=torch.float32, device=x.device)
        n = torch.zeros((), dtype=torch.int64, device=x.device)
        for c in range(S // C):
            sl = slice(c * C, (c + 1) * C)
            nll_c, n_c = checkpoint(_chunk_nll, x[:, sl], labels[:, sl],
                                    head, cfg.final_softcap,
                                    use_reentrant=False)
            nll, n = nll + nll_c, n + n_c
        loss = nll / n.clamp_min(1)
    if cfg.has_moe:
        loss = loss + MOE_AUX_COEF * aux / cfg.num_layers
    return loss


def decode_step(params, cfg: ArchConfig, token, cache, index=0, *,
                compute_dtype=torch.bfloat16, impl: str = "auto"):
    """One serve step: token (B, 1) int32 at position ``index`` against
    ``cache``.  Returns (logits (B, 1, padded_vocab), cache).

    For a paged cache the self-attention ignores ``index``: per-sequence
    positions come from ``cache["length"]`` and only ``cache["active"]``
    slots advance — inactive slots compute but write the pool's scratch
    page (their recurrent states and shift registers step too; a prefill
    overwrites them at the next admission).  ``impl`` picks the paged
    attention path (``kernels.ops``)."""
    paged = isinstance(cache, dict)
    x = _embed(params, cfg, token, compute_dtype)
    if cfg.pos_embed == "learned":
        pos = (params["pos"][cache["length"].long()][:, None] if paged
               else params["pos"][index][None, None])
        x = x + pos.to(compute_dtype)
    layers = cache["layers"] if paged else cache
    pctx = ((cache["page_table"], cache["length"], cache["active"])
            if paged else None)
    for r in range(cfg.repeats):
        p_r = _layer_views(params["blocks"], r)
        c_r = _layer_views(layers, r)
        for j, spec in enumerate(cfg.pattern):
            x = act.shard_batch_act(_decode_layer(
                cfg, spec, p_r[j], x, c_r[j], index, paged=pctx, impl=impl))
    logits = _head(params, cfg, x, compute_dtype)
    if paged:
        cache = {**cache,
                 "length": cache["length"] + cache["active"].to(torch.int32)}
    return logits, cache


# --------------------------------------------------------------------------
# prefill + decode loop (the serve hot path)
# --------------------------------------------------------------------------


def _dense_prefill_write(cache, k, v, positions, lengths):
    """Fill a dense ring buffer from a prefilled sequence in one scatter
    (in place).  Padded positions (≥ length) keep ``pos = -1``; when S
    exceeds the ring length only the last L tokens are kept."""
    L = cache["k"].shape[1]
    B, S = k.shape[:2]
    if S > L:
        k, v, positions = k[:, -L:], v[:, -L:], positions[:, -L:]
    slots = (positions % L).long()
    b_ix = torch.arange(B, device=k.device)[:, None]
    pos = torch.where(positions < lengths[:, None], positions, -1)
    cache["k"][b_ix, slots] = k.to(cache["k"].dtype)
    cache["v"][b_ix, slots] = v.to(cache["v"].dtype)
    cache["pos"][b_ix, slots] = pos.to(torch.int32)
    return cache


def _prefill_layer(cfg, spec: LayerSpec, p, x, cache, positions, lengths,
                   table):
    """One prefill layer: forward + fill this layer's decode cache (in
    place).  Cross-attention attends the cache's ``ck``/``cv``."""
    p = act.gather_params(_cast(p, x.dtype), cfg)
    h = _norm(cfg, p["norm1"], x)
    if spec.mixer in ("attn", "attn+cross"):
        y, k, v = attn_mod.prefill_attention(
            p["mixer"], h, _attn_spec(cfg, spec), positions=positions,
            lengths=lengths)
        if table is not None:
            paged_k.paged_write_prefill(cache["kp"], cache["vp"], k, v, table,
                                        lengths)
        else:
            _dense_prefill_write(cache, k, v, positions, lengths)
        if spec.mixer == "attn+cross":
            if spec.post_norm:
                y = _norm(cfg, p["norm_post1"], y)
            x = x + y
            h = _norm(cfg, p["norm_cross"], x)
            y = attn_mod.attention_with_kv(
                p["cross"], h, cache["ck"], cache["cv"],
                _cross_spec(cfg, spec), positions=positions)
    elif spec.mixer == "cross_attn":
        y = attn_mod.attention_with_kv(p["mixer"], h, cache["ck"],
                                       cache["cv"], _cross_spec(cfg, spec),
                                       positions=positions)
    elif spec.mixer == "mamba":
        y, state = mamba_mod.mamba(p["mixer"], h, d_state=cfg.mamba_d_state,
                                   d_conv=cfg.mamba_d_conv,
                                   return_state=True)
        _copy_state(cache, state)
    else:
        y, state = rwkv_mod.time_mix(p["mixer"], h,
                                     head_size=cfg.rwkv_head_size,
                                     return_state=True)
        _copy_state(cache, state)
    if spec.post_norm and spec.mixer != "attn+cross":
        y = _norm(cfg, p["norm_post1"], y)
    return _ffn_block(cfg, spec, p, x + y, mode="prefill", cache=cache)[0]


def prefill(params, cfg: ArchConfig, tokens, cache, *, lengths=None,
            compute_dtype=torch.bfloat16):
    """Batched prefill: ONE forward pass that fills the decode cache.

    tokens: (B, S) int32, right-padded when ``lengths (B,)`` is given —
    sample the first generated token from ``logits[b, lengths[b]-1]``.
    The causal attention follows ``cfg.attn_impl``.  Attention layers
    mask padded keys exactly; recurrent mixers (Mamba / RWKV) fold the
    whole padded window into their state, so ragged ``lengths`` is only
    right for attention archs — prefill recurrent archs at their exact
    prompt length (``serve_continuous`` admits each sequence unpadded).
    Returns (logits (B, S, padded_vocab), cache)."""
    paged = isinstance(cache, dict)
    B, S = tokens.shape
    dev = tokens.device
    x = _embed(params, cfg, tokens, compute_dtype)
    if cfg.pos_embed == "learned":
        x = x + params["pos"][:S].to(compute_dtype)
    x = act.shard_batch_act(x)
    positions = _arange_positions(B, S, dev)
    lens = (torch.full((B,), S, dtype=torch.int32, device=dev)
            if lengths is None
            else torch.as_tensor(lengths, dtype=torch.int32, device=dev))
    layers = cache["layers"] if paged else cache
    table = cache["page_table"] if paged else None
    for r in range(cfg.repeats):
        p_r = _layer_views(params["blocks"], r)
        c_r = _layer_views(layers, r)
        for j, spec in enumerate(cfg.pattern):
            x = act.shard_batch_act(_prefill_layer(
                cfg, spec, p_r[j], x, c_r[j], positions, lens, table))
    logits = _head(params, cfg, x, compute_dtype)
    if paged:
        cache = {**cache,
                 "length": torch.where(cache["active"], lens, 0).to(
                     torch.int32)}
    return logits, cache


def sample_logits(logits, generator: torch.Generator | None = None, *,
                  temperature: float = 1.0, top_k: int = 0,
                  top_p: float = 1.0, noise=None):
    """Sample next tokens from ``logits (..., V)`` → int32 ``(...)``.

    Filtered-softmax sampling as in the reference: logits are divided by
    ``temperature``, truncated to the ``top_k`` highest (0 = off) and to
    the smallest prefix whose probability mass reaches ``top_p`` (1.0 =
    off; the argmax token is always kept), then drawn by the Gumbel-max
    trick ``argmax(logits + gumbel)`` — what ``jax.random.categorical``
    computes.  ``noise`` (same shape as ``logits``) supplies the Gumbel
    samples; without it they are drawn from ``generator``."""
    V = logits.shape[-1]
    lg = logits.float() / max(temperature, 1e-6)
    if top_k and 0 < top_k < V:
        kth = torch.topk(lg, top_k, dim=-1).values[..., -1:]
        lg = torch.where(lg < kth, -torch.inf, lg)
    if top_p < 1.0:
        desc = torch.sort(lg, dim=-1, descending=True).values
        probs = torch.softmax(desc, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        # keep tokens whose preceding cumulative mass is < top_p (the
        # first is always kept: its preceding mass is 0)
        keep = (cum - probs) < top_p
        thresh = torch.where(keep, desc, torch.inf).amin(-1, keepdim=True)
        lg = torch.where(lg < thresh, -torch.inf, lg)
    if noise is None:
        u = torch.rand(lg.shape, generator=generator, device=lg.device,
                       dtype=torch.float32)
        tiny = torch.finfo(torch.float32).tiny
        noise = -torch.log(-torch.log(u.clamp_min(tiny)))
    return torch.argmax(lg + noise.to(lg.device), dim=-1).to(torch.int32)


def decode_loop(params, cfg: ArchConfig, token, cache, index, steps: int, *,
                compute_dtype=torch.bfloat16,
                generator: torch.Generator | None = None,
                temperature: float = 1.0, top_k: int = 0,
                top_p: float = 1.0, impl: str = "auto"):
    """``steps`` decode iterations in a Python loop; the generated tokens
    stay on the device and are stacked once, so the caller makes one
    host copy per chunk.

    token: (B, 1) int32 — the first token to feed (also the first token
    emitted).  ``index`` is the start position for a dense cache
    (ignored by paged caches).  ``generator=None`` decodes greedily;
    with a generator every step samples through :func:`sample_logits`.
    Returns (tokens (B, steps), next_token (B, 1), cache)."""
    V = cfg.vocab
    toks = []
    tok = token
    for i in range(steps):
        logits, cache = decode_step(params, cfg, tok, cache, index + i,
                                    compute_dtype=compute_dtype, impl=impl)
        if generator is None:
            ntok = torch.argmax(logits[:, :, :V], dim=-1).to(torch.int32)
        else:
            ntok = sample_logits(logits[:, -1, :V], generator,
                                 temperature=temperature, top_k=top_k,
                                 top_p=top_p)[:, None]
        toks.append(tok[:, 0])
        tok = ntok
    return torch.stack(toks, dim=1), tok, cache


def slot_cache(cache, slot: int):
    """One batch slot's view of a paged cache (B=1), for per-admission
    prefill: the pools (``kp``/``vp``) are shared whole, so a prefill on
    the view writes the slot's pages in place; per-slot state (recurrent
    mixers, cross k/v) is a view of the slot's row, so the prefill writes
    it in place too."""
    def per_layer(d):
        return {k: (v if k in _POOL_KEYS else v[:, slot:slot + 1])
                for k, v in d.items()}

    return {
        "layers": tuple(per_layer(d) for d in cache["layers"]),
        "page_table": cache["page_table"][slot:slot + 1],
        "length": cache["length"][slot:slot + 1],
        "active": torch.ones(1, dtype=torch.bool,
                             device=cache["length"].device),
    }


def merge_slot_cache(cache, sub, slot: int):
    """Merge a :func:`slot_cache` view updated by :func:`prefill` back
    into the full paged cache: the pools and the slot's state were
    written in place through the view, so only the slot's length
    moves."""
    length = cache["length"].clone()
    length[slot] = sub["length"][0]
    return {**cache, "length": length}
