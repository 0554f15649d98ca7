"""Decode KV traffic accounting (the part of ``repro.models.profile`` the
serve path uses; the scheduler's layer profiles come with queue 1
item 12)."""

from __future__ import annotations

from repro_torch.models.config import ArchConfig


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
