"""Analytic layer profiles of the architectures for the HeterPS
scheduler, and decode KV traffic accounting (port of
``repro.models.profile``).

:func:`profile_arch` turns an :class:`ArchConfig` into the per-layer
(kind, flops, input_bytes, weight_bytes, output_bytes) sequence the cost
model profiles — embedding and LM head included — so the scheduler
(:mod:`repro_torch.core`) can plan an arch over a heterogeneous fleet.
FLOPs are per token at the given training context length.  NumPy and
Python arithmetic only: no tensor, no device.
"""

from __future__ import annotations

from repro_torch.configs import get_config
from repro_torch.core.profiles import LayerProfile, profile_layers
from repro_torch.models.config import ArchConfig
from repro_torch.nn.moe import moe_capacity

_F = 4  # fp32 bytes


def _effective_kv_len(window: int | None, kv_len: int, cache_len: int,
                      page_size: int | None) -> int:
    """KV positions one decode token actually reads from one layer's
    cache: the whole (window-capped) ring when dense, or only the pages
    overlapping the live span ``[max(0, t-window+1), t]`` when paged."""
    if page_size is None:
        return min(cache_len, window or cache_len)
    t = max(kv_len - 1, 0)
    first = 0 if window is None else max(0, t - window + 1)
    return (t // page_size - first // page_size + 1) * page_size


def kv_read_bytes_per_token(cfg: ArchConfig, kv_len: int, *,
                            cache_len: int, page_size: int | None = None,
                            bytes_per_el: int = 4) -> float:
    """Per-decoded-token KV-cache read traffic summed over the
    self-attention layers: the whole ring when dense (``page_size=None``),
    only the pages overlapping the live span when paged."""
    total = 0.0
    row = 2 * cfg.n_kv_heads * cfg.head_dim * bytes_per_el   # k + v
    for i in range(cfg.num_layers):
        spec = cfg.pattern[i % len(cfg.pattern)]
        if spec.mixer not in ("attn", "attn+cross"):
            continue
        total += _effective_kv_len(spec.window, kv_len, cache_len,
                                   page_size) * row
    return total


def _layer_rows(cfg: ArchConfig, *, seq: int,
                decode_kv: tuple | None = None) -> list[tuple]:
    d, hd = cfg.d_model, cfg.head_dim
    H, KV = cfg.n_heads, cfg.n_kv_heads
    rows: list[tuple] = []
    # input embedding — the data-intensive sparse lookup
    rows.append(("embedding", 2.0 * d, 64.0, cfg.padded_vocab * d * _F,
                 d * _F))
    for i in range(cfg.num_layers):
        spec = cfg.pattern[i % len(cfg.pattern)]
        flops = 0.0
        w_bytes = 0.0
        in_bytes = d * _F
        if spec.mixer in ("attn", "cross_attn", "attn+cross"):
            proj = 2.0 * d * (H + 2 * KV) * hd + 2.0 * H * hd * d
            ctx = min(seq, spec.window or seq)
            score = 4.0 * ctx * H * hd
            n_attn = 2 if spec.mixer == "attn+cross" else 1
            flops += n_attn * (proj + score)
            w_bytes += n_attn * (2 * d * (H + 2 * KV) * hd) * _F
            kind = "cross_attention" if spec.mixer != "attn" else "attention"
            if decode_kv is not None and spec.mixer != "cross_attn":
                # decode profiling: charge the true per-token KV read —
                # used pages for the paged cache, the whole ring for dense
                kv_len, cache_len, page_size = decode_kv
                eff = _effective_kv_len(spec.window, kv_len, cache_len,
                                        page_size)
                in_bytes += 2.0 * eff * KV * hd * _F
        elif spec.mixer == "mamba":
            din = cfg.mamba_expand * d
            flops += (2.0 * d * 2 * din + 2.0 * din * d
                      + 9.0 * din * cfg.mamba_d_state)
            w_bytes += (d * 2 * din + din * d + din * 4) * _F
            kind = "ssm"
        else:  # rwkv
            flops += 2.0 * 5 * d * d + 4.0 * d * cfg.rwkv_head_size
            w_bytes += 5 * d * d * _F
            kind = "ssm"
        if spec.ffn == "dense":
            flops += 6.0 * d * cfg.d_ff
            w_bytes += 3 * d * cfg.d_ff * _F
        elif spec.ffn == "moe":
            fe = cfg.moe_d_ff or cfg.d_ff
            # the expert SwiGLU runs over the full (E, C) capacity slabs,
            # empty slots included, so per-token FFN FLOPs scale with
            # E·C/S (≈ K·cf rounded up to the slab's multiple of 8)
            E, K = cfg.moe_experts, cfg.moe_top_k
            C = moe_capacity(seq, E, K, cfg.moe_capacity_factor)
            slots_per_tok = E * C / seq
            flops += 6.0 * d * fe * slots_per_tok + 2.0 * d * E
            w_bytes += 3 * d * fe * E * _F
            # dispatch writes one activation row per slot and combine
            # reads K gate-weighted rows back per token (combine's own
            # write is the layer output, counted in output_bytes)
            in_bytes += (slots_per_tok + K) * d * _F
        elif spec.ffn == "channel_mix":
            flops += 2.0 * d * cfg.d_ff + 2.0 * cfg.d_ff * d + 2.0 * d * d
            w_bytes += (2 * d * cfg.d_ff + d * d) * _F
        rows.append((kind, flops, in_bytes, w_bytes, d * _F))
    # LM head — compute-dense matmul over the (padded) vocab
    rows.append(("fc", 2.0 * d * cfg.padded_vocab, d * _F,
                 d * cfg.padded_vocab * _F, 32.0))
    return rows


def profile_arch(arch, fleet, *, seq: int = 4096,
                 decode_kv_len: int | None = None,
                 kv_cache_len: int | None = None,
                 kv_page_size: int | None = None) -> list[LayerProfile]:
    """Layer profiles of ``arch`` (an arch id, resolved by
    :func:`repro_torch.configs.get_config`, or an :class:`ArchConfig`)
    over ``fleet``.

    ``decode_kv_len`` switches the attention rows to decode-mode KV
    accounting: each token reads the cache — the whole ``kv_cache_len``
    ring when ``kv_page_size`` is None (dense), or only the used pages of
    a ``kv_page_size``-paged pool at sequence length ``decode_kv_len``."""
    cfg = get_config(arch) if isinstance(arch, str) else arch
    decode_kv = None
    if decode_kv_len is not None:
        decode_kv = (decode_kv_len, kv_cache_len or seq, kv_page_size)
    return profile_layers(_layer_rows(cfg, seq=seq, decode_kv=decode_kv),
                          fleet)
