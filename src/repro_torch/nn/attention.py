"""GQA attention with RoPE, sliding window and logit soft-capping:
full-sequence self- and cross-attention (training, encoder), prefill,
cross-attention over precomputed k/v, the dense ring-buffer decode (the
oracle, and the cross decode) and paged decode (port of
``repro.nn.attention``).

Full-sequence, cross and causal prefill attention go through
``kernels.ops.flash_attention`` (the Hopper flash kernels, forward and
backward, for CUDA tensors), where the reference runs jnp
``_sdpa_direct`` / ``_sdpa_blockwise``; those two stay here as the
oracles.  Paged decode goes through ``kernels.ops.paged_attention_decode``.
Cache updates are in place: the caller owns the cache tensors and the
functions write the new token's k/v into them (the reference returns
fresh arrays instead).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.kernels import ops as kernel_ops
from repro_torch.kernels import paged_attention as paged_k
from repro_torch.nn.base import apply_rope, rmsnorm, softcap
from repro_torch.parallel import act

NEG_INF = -1e30
#: sequences longer than this use the blockwise path (bounds the live
#: logits tile instead of materializing the full S×S score matrix)
BLOCKWISE_THRESHOLD = 2048
KV_BLOCK = 1024


@dataclasses.dataclass(frozen=True)
class AttnSpec:
    n_heads: int
    n_kv_heads: int
    head_dim: int
    causal: bool = True
    window: int | None = None          # sliding-window size (Gemma-2 local)
    logit_softcap: float | None = None
    rope: bool = True
    rope_theta: float = 10000.0
    rope_fraction: float = 1.0
    qk_norm: bool = False              # Qwen3-style per-head RMS on q/k
    #: the port's own: kernels.ops.flash_attention's impl for the
    #: full-sequence paths (ArchConfig.attn_impl)
    impl: str = "auto"


def init_attention(gen: torch.Generator, d_model: int, spec: AttnSpec, *,
                   kv_dim: int | None = None, device=None,
                   dtype=torch.float32):
    """Same distributions and scales as the reference: N(0, 1/d_model)
    for wq/wk/wv, N(0, 1/(H·hd)) for wo; weights are (d_in, d_out)."""
    kv_dim = kv_dim or d_model
    s = 1.0 / math.sqrt(d_model)
    H, KV, hd = spec.n_heads, spec.n_kv_heads, spec.head_dim

    def normal(shape, scale):
        return torch.randn(shape, generator=gen, device=device,
                           dtype=dtype) * scale

    p = {
        "wq": normal((d_model, H * hd), s),
        "wk": normal((kv_dim, KV * hd), s),
        "wv": normal((kv_dim, KV * hd), s),
        "wo": normal((H * hd, d_model), 1.0 / math.sqrt(H * hd)),
    }
    if spec.qk_norm:
        p["q_norm"] = torch.ones(hd, device=device, dtype=dtype)
        p["k_norm"] = torch.ones(hd, device=device, dtype=dtype)
    return p


def _expand_kv(x, n_heads: int):
    """(B, S, KV, hd) → (B, S, H, hd) by repeating each KV head G times."""
    B, S, KV, hd = x.shape
    if KV == n_heads:
        return x
    g = n_heads // KV
    return x[:, :, :, None, :].expand(B, S, KV, g, hd).reshape(B, S, n_heads, hd)


def _mask_bias(q_pos, k_pos, *, causal, window):
    """(B, Sq, Sk) additive mask from query/key positions; ``k_pos < 0``
    marks padding."""
    ok = (k_pos >= 0)[..., None, :].expand(
        *q_pos.shape[:-1], q_pos.shape[-1], k_pos.shape[-1])
    d = q_pos[..., :, None] - k_pos[..., None, :]
    if causal:
        ok = ok & (d >= 0)
    if window is not None:
        ok = ok & (d < window)
    zero = torch.zeros((), dtype=torch.float32, device=ok.device)
    return torch.where(ok, zero, NEG_INF)


def _sdpa_direct(q, k, v, q_pos, k_pos, spec: AttnSpec):
    """Direct attention. q, k, v: (B, S, H, hd) (kv pre-expanded)."""
    scale = 1.0 / math.sqrt(spec.head_dim)
    logits = torch.einsum("bqhd,bshd->bhqs", q, k).float() * scale
    if spec.logit_softcap:
        logits = softcap(logits, spec.logit_softcap)
    logits = logits + _mask_bias(q_pos, k_pos, causal=spec.causal,
                                 window=spec.window)[:, None]
    logits = act.shard_heads(logits, axis=1)
    w = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bhqs,bshd->bqhd", w, v)


def _sdpa_blockwise(q, k, v, q_pos, k_pos, spec: AttnSpec):
    """Flash-style online softmax over KV blocks of ``KV_BLOCK`` keys (a
    Python loop where the reference scans); same math as
    :func:`_sdpa_direct`."""
    B, Sq, H, hd = q.shape
    Sk = k.shape[1]
    scale = 1.0 / math.sqrt(spec.head_dim)
    nblk = -(-Sk // KV_BLOCK)
    pad = nblk * KV_BLOCK - Sk
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
        k_pos = torch.nn.functional.pad(k_pos, (0, pad), value=-(10**9))
    m = torch.full((B, H, Sq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, H, Sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, H, Sq, hd), dtype=torch.float32, device=q.device)
    for j in range(nblk):
        blk = slice(j * KV_BLOCK, (j + 1) * KV_BLOCK)
        s = torch.einsum("bqhd,bshd->bhqs", q, k[:, blk]).float() * scale
        if spec.logit_softcap:
            s = softcap(s, spec.logit_softcap)
        s = s + _mask_bias(q_pos, k_pos[:, blk], causal=spec.causal,
                           window=spec.window)[:, None]
        s = act.shard_heads(s, axis=1)
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bhqs,bshd->bhqd", p, v[:, blk].float())
        m = m_new
    out = acc / torch.clamp(l[..., None], min=1e-30)
    return out.transpose(1, 2).to(q.dtype)                  # (B, Sq, H, hd)


# --------------------------------------------------------------------------
# full-sequence attention (training)
# --------------------------------------------------------------------------


def _project_qkv(p, x, kv_x, spec: AttnSpec, q_pos, k_pos):
    """q (B, Sq, H, hd) and k, v (B, Sk, H, hd) — normed, roped, KV heads
    expanded to H."""
    B, Sq, _ = x.shape
    H, KV, hd = spec.n_heads, spec.n_kv_heads, spec.head_dim
    q = act.split_heads(x @ p["wq"], H, hd)
    k = act.split_heads(kv_x @ p["wk"], KV, hd)
    v = act.split_heads(kv_x @ p["wv"], KV, hd)
    if spec.qk_norm:
        q = rmsnorm(q, p["q_norm"])
        k = rmsnorm(k, p["k_norm"])
    if spec.rope:
        q = apply_rope(q, q_pos, theta=spec.rope_theta,
                       fraction=spec.rope_fraction)
        k = apply_rope(k, k_pos, theta=spec.rope_theta,
                       fraction=spec.rope_fraction)
    return (act.shard_heads(q, axis=2),
            act.shard_heads(_expand_kv(k, H), axis=2),
            act.shard_heads(_expand_kv(v, H), axis=2))


def attention(p, x, spec: AttnSpec, *, positions, kv_x=None,
              kv_positions=None):
    """Full-sequence attention (training / forward / encoder).  x: (B, Sq,
    D); ``kv_x``: a cross-attention source (B, Sk, Dkv) or None;
    positions: (B, Sq) int32.  Returns (B, Sq, D).

    The attention runs in :func:`kernels.ops.flash_attention` on
    (B, H, S, hd) views (``spec.impl``: ``auto`` = the CUDA kernels for
    CUDA tensors and the plain version for CPU tensors, ``ref``, ``cuda``).
    The kernel masks by *index* where the reference masks by
    ``positions`` / ``kv_positions``; the two agree because every caller
    passes ``arange`` positions (``models.decoder`` builds them so, as the
    reference's does).  Nothing checks it here: a check would sync the
    host every layer.  The decoder's cross-attention passes a non-causal
    spec (every context frame is attended; ROADMAP.md R7)."""
    B, Sq, _ = x.shape
    self_attn = kv_x is None
    q, k, v = _project_qkv(p, x, x if self_attn else kv_x, spec, positions,
                           positions if self_attn else kv_positions)
    o = kernel_ops.flash_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        causal=spec.causal, window=spec.window,
        softcap=spec.logit_softcap, impl=spec.impl).transpose(1, 2)
    return o.reshape(B, Sq, spec.n_heads * spec.head_dim) @ p["wo"]


# --------------------------------------------------------------------------
# prefill (one forward that also yields the cacheable k/v)
# --------------------------------------------------------------------------


def _project_q(p, x, spec: AttnSpec, positions):
    B, S, _ = x.shape
    q = act.split_heads(x @ p["wq"], spec.n_heads, spec.head_dim)
    if spec.qk_norm:
        q = rmsnorm(q, p["q_norm"])
    if spec.rope:
        q = apply_rope(q, positions, theta=spec.rope_theta,
                       fraction=spec.rope_fraction)
    return q


def prefill_attention(p, x, spec: AttnSpec, *, positions, lengths=None):
    """Full-sequence self-attention that ALSO returns the (unexpanded,
    post-rope) k/v so the caller can fill a decode cache in one shot.

    x: (B, S, D); positions: (B, S) = arange(S) per row (as
    ``models.decoder.prefill`` builds them); ``lengths (B,)`` masks
    right-padded prompts — padded keys are never attended by a real query
    (padded *queries* produce garbage rows the caller discards).  A
    causal spec runs :func:`kernels.ops.flash_attention` (``spec.impl`` as
    in :func:`attention`): right-padded keys lie after every real query, so
    the causal mask by index hides them.  A non-causal spec keeps the
    position-masked ``_sdpa`` paths.  Returns
    (out (B, S, D), k (B, S, KV, hd), v (B, S, KV, hd)).
    """
    B, S, _ = x.shape
    H, KV, hd = spec.n_heads, spec.n_kv_heads, spec.head_dim
    q = _project_q(p, x, spec, positions)
    k = act.split_heads(x @ p["wk"], KV, hd)
    v = act.split_heads(x @ p["wv"], KV, hd)
    if spec.qk_norm:
        k = rmsnorm(k, p["k_norm"])
    if spec.rope:
        k = apply_rope(k, positions, theta=spec.rope_theta,
                       fraction=spec.rope_fraction)
    q = act.shard_heads(q, axis=2)
    ke = act.shard_heads(_expand_kv(k, H), axis=2)
    ve = act.shard_heads(_expand_kv(v, H), axis=2)
    if spec.causal:
        o = kernel_ops.flash_attention(
            q.transpose(1, 2), ke.transpose(1, 2), ve.transpose(1, 2),
            causal=True, window=spec.window, softcap=spec.logit_softcap,
            impl=spec.impl).transpose(1, 2)
        return o.reshape(B, S, H * hd) @ p["wo"], k, v
    k_pos = positions
    if lengths is not None:
        k_pos = torch.where(positions < lengths[:, None], positions, -1)
    if S <= BLOCKWISE_THRESHOLD:
        o = _sdpa_direct(q, ke, ve, positions, k_pos, spec)
    else:
        o = _sdpa_blockwise(q, ke, ve, positions, k_pos, spec)
    return o.reshape(B, S, H * hd) @ p["wo"], k, v


def attention_with_kv(p, x, k, v, spec: AttnSpec, *, positions):
    """Cross-attention over precomputed (projected, unexpanded) k/v
    (B, Sk, KV, hd): the full-sequence analogue of
    ``decode_attention(cross=True)``.  q is normed and roped at
    ``positions``; every key is attended (non-causal, no window), through
    :func:`kernels.ops.flash_attention` (``spec.impl``)."""
    B, S, _ = x.shape
    H = spec.n_heads
    q = act.shard_heads(_project_q(p, x, spec, positions), axis=2)
    k = act.shard_heads(_expand_kv(k.to(q.dtype), H), axis=2)
    v = act.shard_heads(_expand_kv(v.to(q.dtype), H), axis=2)
    o = kernel_ops.flash_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        causal=False, window=None,
        softcap=spec.logit_softcap, impl=spec.impl).transpose(1, 2)
    return o.reshape(B, S, H * spec.head_dim) @ p["wo"]


# --------------------------------------------------------------------------
# dense ring-buffer decode (the oracle)
# --------------------------------------------------------------------------


def init_kv_cache(batch: int, max_len: int, spec: AttnSpec,
                  dtype=torch.bfloat16, *, device=None):
    shape = (batch, max_len, spec.n_kv_heads, spec.head_dim)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "pos": torch.full((batch, max_len), -1, dtype=torch.int32,
                          device=device),
    }


def _decode_qkv(p, x, q_pos, spec: AttnSpec):
    """q (B, H, hd) and the new token's k/v (B, KV, hd), normed and roped
    at ``q_pos (B, 1)``."""
    B = x.shape[0]
    H, KV, hd = spec.n_heads, spec.n_kv_heads, spec.head_dim
    q = act.split_heads(x @ p["wq"], H, hd)
    k_new = act.split_heads(x @ p["wk"], KV, hd)
    v_new = act.split_heads(x @ p["wv"], KV, hd)
    if spec.qk_norm:
        q = rmsnorm(q, p["q_norm"])
        k_new = rmsnorm(k_new, p["k_norm"])
    if spec.rope:
        q = apply_rope(q, q_pos, theta=spec.rope_theta,
                       fraction=spec.rope_fraction)
        k_new = apply_rope(k_new, q_pos, theta=spec.rope_theta,
                           fraction=spec.rope_fraction)
    return q[:, 0], k_new[:, 0], v_new[:, 0]


def decode_attention(p, x, cache, index, spec: AttnSpec, *,
                     cross: bool = False):
    """One-token decode against a dense ring buffer. x: (B, 1, D);
    ``cache['k']``: (B, L, KV, hd); ``index``: the new token's position
    (one for the whole batch).

    The new token writes slot ``index % L`` in place and ``cache['pos']``
    records true positions for masking.  Cross-attention (``cross=True``)
    reads a fixed cache ``{"k", "v"}`` of context keys, attends every one
    and writes nothing; its ``index`` may also be a (B,) tensor of
    per-sequence positions (the paged decode passes its ``q_pos``).
    Returns (out (B, 1, D), cache).
    """
    B = x.shape[0]
    H, KV, hd = spec.n_heads, spec.n_kv_heads, spec.head_dim
    if cross:
        q_pos = None                    # read only by rope
        if spec.rope:
            q_pos = torch.as_tensor(index, dtype=torch.int32,
                                    device=x.device).reshape(-1, 1)
            q_pos = q_pos.expand(B, 1)
        q = _project_q(p, x, spec, q_pos)[:, 0]
        k, v = cache["k"], cache["v"]
        valid = None
    else:
        q_pos = torch.full((B, 1), index, dtype=torch.int32, device=x.device)
        q, k_new, v_new = _decode_qkv(p, x, q_pos, spec)
        L = cache["k"].shape[1]
        slot = index % L
        act.write_index(cache["k"], 1, slot, k_new.to(cache["k"].dtype))
        act.write_index(cache["v"], 1, slot, v_new.to(cache["v"].dtype))
        act.write_index(cache["pos"], 1, slot, index)
        k, v, k_pos = cache["k"], cache["v"], cache["pos"]
        valid = (k_pos >= 0) & (k_pos <= index)
        if spec.window is not None:
            valid &= k_pos > index - spec.window
    # grouped GQA at decode: q-len is 1, so the (KV, G) form needs no
    # KV expansion
    scale = 1.0 / math.sqrt(hd)
    G = H // KV
    qg = act.unshard(q, 1).reshape(B, 1, KV, G, hd)
    logits = torch.einsum("bqkgd,bskd->bkgqs", qg,
                          k.to(q.dtype)).float() * scale
    if spec.logit_softcap:
        logits = softcap(logits, spec.logit_softcap)
    if valid is not None:
        logits = torch.where(valid[:, None, None, None, :], logits, NEG_INF)
    w = torch.softmax(logits, dim=-1).to(q.dtype)
    o = torch.einsum("bkgqs,bskd->bqkgd", w, v.to(q.dtype)).reshape(
        B, 1, H * hd)
    return o @ p["wo"], cache


# --------------------------------------------------------------------------
# paged decode (shared page pool; see kernels/paged_attention.py)
# --------------------------------------------------------------------------


def init_paged_kv_cache(num_pages: int, page_size: int, spec: AttnSpec,
                        dtype=torch.bfloat16, *, device=None):
    """One layer's share of the page pool: (num_pages, page_size, KV, hd)
    k/v tensors.  The page table / lengths live once per model (shared
    by every layer), not here."""
    shape = (num_pages, page_size, spec.n_kv_heads, spec.head_dim)
    return {"kp": torch.zeros(shape, dtype=dtype, device=device),
            "vp": torch.zeros(shape, dtype=dtype, device=device)}


def paged_decode_attention(p, x, cache, page_table, q_pos, spec: AttnSpec, *,
                           active=None, impl: str = "auto"):
    """One-token decode against the shared page pool.

    x: (B, 1, D); ``cache`` holds this layer's pool ({"kp", "vp"});
    page_table: (B, P) int32; q_pos: (B,) int32 — per-sequence position
    of the new token (ragged across the batch).  Writes the new k/v into
    the sequence's page (in place), then attends positions
    ``max(0, q_pos-window+1) .. q_pos`` — reading only the pages that
    hold them.  Same GQA grouped form / rope / qk-norm / softcap / window
    semantics as :func:`decode_attention`.  Returns (out (B, 1, D),
    {"kp", "vp"}).
    """
    B = x.shape[0]
    H, KV, hd = spec.n_heads, spec.n_kv_heads, spec.head_dim
    if active is None:
        active = torch.ones(B, dtype=torch.bool, device=x.device)
    q, k_new, v_new = _decode_qkv(p, x, q_pos[:, None], spec)
    kp, vp = paged_k.paged_write(cache["kp"], cache["vp"], k_new, v_new,
                                 page_table, q_pos, active)
    qg = q.reshape(B, KV, H // KV, hd)
    o = kernel_ops.paged_attention_decode(
        qg, kp, vp, page_table, q_pos, window=spec.window,
        softcap=spec.logit_softcap, impl=impl)
    return o.reshape(B, 1, H * hd) @ p["wo"], {"kp": kp, "vp": vp}
