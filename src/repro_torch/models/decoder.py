"""Block-pattern decoder: init, prefill, decode (port of
``repro.models.decoder`` for attention archs with dense or MoE FFNs).

Parameters keep the reference's tree: ``embed``, ``final_norm``,
optional ``lm_head`` and ``blocks`` — a tuple over the pattern whose
leaves are stacked on a leading ``repeats`` axis — with weights
``(d_in, d_out)`` used as ``x @ w``.  Layer ``r`` of pattern position
``j`` is the view ``blocks[j][...][r]``.

Entry points:
  * :func:`init_model`  — parameter tree from a seeded ``torch.Generator``
  * :func:`forward`     — full-sequence logits (+ MoE aux loss)
  * :func:`loss_fn`     — token cross-entropy (+ MoE aux loss), the
    training objective
  * :func:`init_cache`  — decode cache (paged page pool or dense rings)
  * :func:`prefill`     — one forward that fills the cache
  * :func:`decode_step` — one-token step against the cache
  * :func:`decode_loop` — ``steps`` decode steps, tokens kept on device

Caches are updated in place (the new k/v land in the caller's pool or
ring tensors); functions still return the cache dict so call sites read
like the reference's.  Mamba/RWKV mixers, cross-attention and encoders
wait for later slices and raise ``NotImplementedError``.
"""

from __future__ import annotations

import math
from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.kernels import paged_attention as paged_k
from repro_torch.models.config import ArchConfig, LayerSpec
from repro_torch.nn import attention as attn_mod
from repro_torch.nn import moe as moe_mod
from repro_torch.nn.attention import AttnSpec
from repro_torch.nn.base import layernorm, masked_nll, rmsnorm, softcap
from repro_torch.tree import tree_map as _tree_map


def _check_supported(cfg: ArchConfig) -> None:
    for s in cfg.pattern:
        if s.mixer != "attn" or s.ffn not in ("dense", "moe", "none"):
            raise NotImplementedError(
                f"{cfg.name}: mixer {s.mixer!r} / ffn {s.ffn!r} are not "
                "ported yet (ROADMAP.md queue 1 item 10)")
    if cfg.encoder is not None or cfg.cross_kv_len or cfg.pos_embed == "learned":
        raise NotImplementedError(
            f"{cfg.name}: encoders, cross-attention and learned positions "
            "are not ported yet (ROADMAP.md queue 1 item 10)")


def _attn_spec(cfg: ArchConfig, spec: LayerSpec, *, causal=True) -> AttnSpec:
    return AttnSpec(
        n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads, head_dim=cfg.head_dim,
        causal=causal, window=spec.window, logit_softcap=spec.logit_softcap,
        rope=spec.rope and cfg.pos_embed == "rope",
        rope_theta=cfg.rope_theta, rope_fraction=spec.rope_fraction,
        qk_norm=spec.qk_norm, impl=cfg.attn_impl,
    )


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
    p["mixer"] = attn_mod.init_attention(gen, d, _attn_spec(cfg, spec),
                                         device=device, dtype=dtype)
    if spec.ffn != "none":
        p["norm2"] = _norm_init(cfg, d, device, dtype)
    if spec.ffn == "dense":
        p["ffn"] = moe_mod.init_dense_ffn(gen, d, cfg.d_ff, device=device,
                                          dtype=dtype)
    elif spec.ffn == "moe":
        p["ffn"] = moe_mod.init_moe(gen, d, cfg.moe_d_ff or cfg.d_ff,
                                    cfg.moe_experts, device=device,
                                    dtype=dtype)
    if spec.post_norm:
        p["norm_post1"] = _norm_init(cfg, d, device, dtype)
        if spec.ffn != "none":
            p["norm_post2"] = _norm_init(cfg, d, device, dtype)
    return p


def init_model(cfg: ArchConfig, *, seed: int = 0, device=None,
               dtype=torch.float32):
    """Random parameters with the reference's distributions and scales
    (embedding and head N(0, 1/d_model), projections as in
    ``nn.attention.init_attention`` / ``nn.moe.init_dense_ffn`` /
    ``nn.moe.init_moe``, norms 1), drawn layer by layer from a
    ``torch.Generator`` seeded with ``seed`` on ``device``.  Each layer is
    copied into its slot of the stacked leaves as it is drawn, so the
    peak is the stacked tree plus one layer (OLMoE-1B-7B's expert weights
    are 27 GB in float32).
    The draws differ from ``jax.random``'s: parity tests convert the
    reference's weights with :func:`repro_torch.models.convert.params_from_jax`.
    """
    cfg.validate()
    _check_supported(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    d, vp = cfg.d_model, cfg.padded_vocab
    s = 1.0 / math.sqrt(d)
    params: dict[str, Any] = {
        "embed": torch.randn((vp, d), generator=gen, device=dev,
                             dtype=dtype) * s,
        "final_norm": _norm_init(cfg, d, dev, dtype),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = torch.randn((d, vp), generator=gen, device=dev,
                                        dtype=dtype) * s
    params["blocks"] = tuple(_init_stacked(gen, cfg, spec, dev, dtype)
                             for spec in cfg.pattern)
    return params


def _init_stacked(gen, cfg: ArchConfig, spec: LayerSpec, device, dtype):
    """``repeats`` layers of ``spec`` stacked on a leading axis, each
    drawn and copied into place in turn."""
    first = _init_layer(gen, cfg, spec, device, dtype)
    out = _tree_map(lambda a: a.new_empty((cfg.repeats, *a.shape)), first)
    for r in range(cfg.repeats):
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


def init_cache(cfg: ArchConfig, batch: int, cache_len: int,
               dtype=torch.bfloat16, *, page_size: int = 16,
               num_pages: int | None = None, device=None):
    """Decode cache, stacked (repeats, …) per pattern position.

    Dense (``cfg.kv_impl == "dense"``): a tuple over the pattern of
    ``{"k", "v", "pos"}`` ring buffers (window-capped length).

    Paged: ``{"layers", "page_table", "length", "active"}`` — the layers
    hold ``{"kp", "vp"}`` page pools of ``num_pages`` pages (default:
    enough for every slot, identity-allocated: slot b owns pages
    ``[1 + b·P, 1 + (b+1)·P)``); below full coverage the table starts at
    the scratch page and the host :class:`~repro_torch.kernels.PagePool`
    assigns it.  ``length`` carries per-sequence positions and ``active``
    masks live slots."""
    _check_supported(cfg)
    dev = resolve_device(device)
    paged = cfg.kv_impl == "paged"
    pages_per_seq = -(-cache_len // page_size)
    if paged and num_pages is None:
        num_pages = 1 + batch * pages_per_seq
    R = cfg.repeats
    caches = []
    for spec in cfg.pattern:
        aspec = _attn_spec(cfg, spec)
        if paged:
            one = attn_mod.init_paged_kv_cache(num_pages, page_size, aspec,
                                               dtype, device=dev)
        else:
            L = cache_len if spec.window is None else min(cache_len,
                                                          spec.window)
            one = attn_mod.init_kv_cache(batch, L, aspec, dtype, device=dev)
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


def _ffn_block(cfg, spec: LayerSpec, p, x, *, with_aux: bool = False):
    """norm2 → dense or MoE FFN → (post-norm) → residual.  The MoE routes
    each sequence as one group (prefill: S tokens; decode: 1) through
    ``cfg.moe_impl``.  Returns ``(x, aux)``: ``aux`` is the MoE's
    load-balance loss when ``with_aux`` (training) and the FFN is an MoE,
    else ``None`` — serving never computes it."""
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
    else:
        y = moe_mod.dense_ffn(p["ffn"], h)
    if spec.post_norm:
        y = _norm(cfg, p["norm_post2"], y)
    return x + y, aux


def _decode_layer(cfg, spec: LayerSpec, p, x, cache, index, *, paged=None,
                  impl: str = "auto"):
    """One decode layer.  ``paged = (page_table, q_pos, active)`` routes
    the self-attention through the shared page pool (ragged per-sequence
    positions); ``None`` keeps the dense ring-buffer path (one
    ``index``)."""
    p = _cast(p, x.dtype)
    aspec = _attn_spec(cfg, spec)
    h = _norm(cfg, p["norm1"], x)
    if paged is not None:
        pt, q_pos, active = paged
        y, upd = attn_mod.paged_decode_attention(
            p["mixer"], h, cache, pt, q_pos, aspec, active=active, impl=impl)
        cache = {**cache, **upd}
    else:
        y, cache = attn_mod.decode_attention(p["mixer"], h, cache, index,
                                             aspec)
    if spec.post_norm:
        y = _norm(cfg, p["norm_post1"], y)
    return _ffn_block(cfg, spec, p, x + y)[0], cache


def _embed(params, cfg: ArchConfig, tokens, compute_dtype):
    x = params["embed"][tokens.long()].to(compute_dtype)
    if cfg.embed_scale:
        x = x * math.sqrt(cfg.d_model)
    return x


def _head_weight(params, cfg: ArchConfig, compute_dtype):
    """(D, padded_vocab): the tied embedding's transpose or ``lm_head``."""
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return head.to(compute_dtype)


def _logits(params, cfg: ArchConfig, x, compute_dtype):
    """Head and final soft-cap of normed hidden states."""
    logits = x @ _head_weight(params, cfg, compute_dtype)
    if cfg.final_softcap:
        logits = softcap(logits.float(), cfg.final_softcap)
    return logits


def _head(params, cfg: ArchConfig, x, compute_dtype):
    """Final norm, head and final soft-cap."""
    return _logits(params, cfg, _norm(cfg, params["final_norm"], x),
                   compute_dtype)


def _layer_views(tree, r: int):
    return _tree_map(lambda a: a[r], tree)


# --------------------------------------------------------------------------
# forward (training)
# --------------------------------------------------------------------------


def _apply_layer(cfg, spec: LayerSpec, p, x, *, positions):
    """One training layer: attention (flash, ``cfg.attn_impl``) then the FFN.
    Returns (x, moe_aux) with moe_aux a float32 scalar tensor."""
    p = _cast(p, x.dtype)
    h = _norm(cfg, p["norm1"], x)
    y = attn_mod.attention(p["mixer"], h, _attn_spec(cfg, spec),
                           positions=positions)
    if spec.post_norm:
        y = _norm(cfg, p["norm_post1"], y)
    x, aux = _ffn_block(cfg, spec, p, x + y, with_aux=True)
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x, aux


def _run_blocks(params, cfg: ArchConfig, x, *, positions, remat=True):
    """Every layer in order (a Python loop where the reference scans the
    stacked blocks).  With ``remat`` each layer is checkpointed
    (``torch.utils.checkpoint``, non-reentrant): its activations are
    recomputed, one layer at a time, in the backward pass, so the forward
    kernels of a layer run twice per training step.  Returns
    (x, summed moe_aux)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for r in range(cfg.repeats):
        p_r = _layer_views(params["blocks"], r)
        for j, spec in enumerate(cfg.pattern):
            def layer(x, _p=p_r[j], _spec=spec):
                return _apply_layer(cfg, _spec, _p, x, positions=positions)

            if remat:
                x, a = checkpoint(layer, x, use_reentrant=False)
            else:
                x, a = layer(x)
            aux = aux + a
    return x, aux


def _hidden(params, cfg: ArchConfig, tokens, *, compute_dtype=torch.bfloat16,
            remat=True):
    """Backbone up to the final norm.  tokens: (B, S) integer; positions
    are ``arange(S)`` per row, which the flash kernel's index masking
    relies on.  Returns (x (B, S, D), moe_aux)."""
    _check_supported(cfg)
    B, S = tokens.shape
    x = _embed(params, cfg, tokens, compute_dtype)
    positions = torch.arange(S, dtype=torch.int32,
                             device=tokens.device).expand(B, S)
    x, aux = _run_blocks(params, cfg, x, positions=positions, remat=remat)
    return _norm(cfg, params["final_norm"], x), aux


def forward(params, cfg: ArchConfig, tokens, *, compute_dtype=torch.bfloat16,
            remat=True):
    """tokens: (B, S) → (logits (B, S, padded_vocab), moe_aux).  The
    attention follows ``cfg.attn_impl``, the MoE ``cfg.moe_impl``."""
    x, aux = _hidden(params, cfg, tokens, compute_dtype=compute_dtype,
                     remat=remat)
    return _logits(params, cfg, x, compute_dtype), aux


#: sequence-chunk length for the loss head: logits materialize one
#: (B, LOSS_CHUNK, vocab) tile at a time (the reference's value)
LOSS_CHUNK = 512
MOE_AUX_COEF = 0.01


def _chunk_nll(x_c, y_c, head, final_softcap):
    """Summed token NLL and token count of one sequence chunk."""
    logits = x_c @ head
    if final_softcap:
        logits = softcap(logits.float(), final_softcap)
    return masked_nll(logits, y_c)


def loss_fn(params, cfg: ArchConfig, batch, *, compute_dtype=torch.bfloat16,
            remat=True):
    """Mean token cross-entropy of ``batch`` ({"tokens", "labels"}, (B, S)
    integer tensors; labels < 0 are ignored), plus
    ``MOE_AUX_COEF · aux / num_layers`` for MoE archs.  The head runs over
    chunks of ``LOSS_CHUNK`` positions (when S is a multiple above it),
    each checkpointed so its (B, chunk, vocab) logits are recomputed in
    the backward pass instead of kept.  The attention follows
    ``cfg.attn_impl``, the MoE ``cfg.moe_impl``."""
    x, aux = _hidden(params, cfg, batch["tokens"], compute_dtype=compute_dtype,
                     remat=remat)
    head = _head_weight(params, cfg, compute_dtype)
    labels = batch["labels"]
    S = x.shape[1]
    C = LOSS_CHUNK if (S % LOSS_CHUNK == 0 and S > LOSS_CHUNK) else S
    nll = torch.zeros((), dtype=torch.float32, device=x.device)
    n = torch.zeros((), dtype=torch.int64, device=x.device)
    for c in range(S // C):
        sl = slice(c * C, (c + 1) * C)
        nll_c, n_c = checkpoint(_chunk_nll, x[:, sl], labels[:, sl], head,
                                cfg.final_softcap, use_reentrant=False)
        nll, n = nll + nll_c, n + n_c
    loss = nll / n.clamp_min(1)
    if cfg.has_moe:
        loss = loss + MOE_AUX_COEF * aux / cfg.num_layers
    return loss


def decode_step(params, cfg: ArchConfig, token, cache, index=0, *,
                compute_dtype=torch.bfloat16, impl: str = "auto"):
    """One serve step: token (B, 1) int32 at position ``index`` against
    ``cache``.  Returns (logits (B, 1, padded_vocab), cache).

    For a paged cache ``index`` is ignored: per-sequence positions come
    from ``cache["length"]`` and only ``cache["active"]`` slots advance —
    inactive slots compute but write the pool's scratch page.  ``impl``
    picks the paged attention path (``kernels.ops``)."""
    paged = isinstance(cache, dict)
    x = _embed(params, cfg, token, compute_dtype)
    layers = cache["layers"] if paged else cache
    pctx = ((cache["page_table"], cache["length"], cache["active"])
            if paged else None)
    for r in range(cfg.repeats):
        p_r = _layer_views(params["blocks"], r)
        c_r = _layer_views(layers, r)
        for j, spec in enumerate(cfg.pattern):
            x, _ = _decode_layer(cfg, spec, p_r[j], x, c_r[j], index,
                                 paged=pctx, impl=impl)
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
    """One prefill layer: forward + fill this layer's decode cache."""
    p = _cast(p, x.dtype)
    h = _norm(cfg, p["norm1"], x)
    y, k, v = attn_mod.prefill_attention(p["mixer"], h, _attn_spec(cfg, spec),
                                         positions=positions, lengths=lengths)
    if table is not None:
        paged_k.paged_write_prefill(cache["kp"], cache["vp"], k, v, table,
                                    lengths)
    else:
        _dense_prefill_write(cache, k, v, positions, lengths)
    if spec.post_norm:
        y = _norm(cfg, p["norm_post1"], y)
    return _ffn_block(cfg, spec, p, x + y)[0]


def prefill(params, cfg: ArchConfig, tokens, cache, *, lengths=None,
            compute_dtype=torch.bfloat16):
    """Batched prefill: ONE forward pass that fills the decode cache.

    tokens: (B, S) int32, right-padded when ``lengths (B,)`` is given —
    sample the first generated token from ``logits[b, lengths[b]-1]``.
    The causal attention follows ``cfg.attn_impl``.
    Returns (logits (B, S, padded_vocab), cache)."""
    paged = isinstance(cache, dict)
    B, S = tokens.shape
    dev = tokens.device
    x = _embed(params, cfg, tokens, compute_dtype)
    positions = torch.arange(S, dtype=torch.int32, device=dev).expand(B, S)
    lens = (torch.full((B,), S, dtype=torch.int32, device=dev)
            if lengths is None
            else torch.as_tensor(lengths, dtype=torch.int32, device=dev))
    layers = cache["layers"] if paged else cache
    table = cache["page_table"] if paged else None
    for r in range(cfg.repeats):
        p_r = _layer_views(params["blocks"], r)
        c_r = _layer_views(layers, r)
        for j, spec in enumerate(cfg.pattern):
            x = _prefill_layer(cfg, spec, p_r[j], x, c_r[j], positions, lens,
                               table)
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
    the view writes the slot's pages in place."""
    return {
        "layers": cache["layers"],
        "page_table": cache["page_table"][slot:slot + 1],
        "length": cache["length"][slot:slot + 1],
        "active": torch.ones(1, dtype=torch.bool,
                             device=cache["length"].device),
    }


def merge_slot_cache(cache, sub, slot: int):
    """Merge a :func:`slot_cache` view updated by :func:`prefill` back
    into the full paged cache: the pools were written in place, so only
    the slot's length moves."""
    length = cache["length"].clone()
    length[slot] = sub["length"][0]
    return {**cache, "length": length}
