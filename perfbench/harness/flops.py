"""The yardstick's arithmetic: H100 peaks, model FLOPs and the least work
each kernel call needs, all from shapes.

Peaks are NVIDIA's data sheet for the H100 SXM at 700 W, dense:
989 TFLOP/s in bfloat16 and 3.35 TB/s of HBM.  A kernel's bound is the
larger of its operations over the peak rate and its bytes over the peak
bandwidth, with every input byte read once and every output byte written
once, counted for the operation (the same whatever implements it).

Model FLOPs: 2 per active parameter a token (the projections, the
router, the experts a token is routed to, the head over the published
vocabulary; not the embedding lookup), plus 4 · head_dim per query head,
layer and key attended (QKᵀ and PV); a causal prompt of S tokens attends
S(S+1)/2 keys in all.  Training counts three times the forward (the
backward's two products per forward product); recomputation is not
counted.
"""

from __future__ import annotations

PEAK_FLOPS = {"bfloat16": 989e12}
PEAK_BYTES_S = 3.35e12


def n_active(m: dict) -> int:
    """Parameters a token multiplies through, without the embedding."""
    d, H, KV, hd, f = (m["d_model"], m["n_heads"], m["n_kv_heads"],
                       m["head_dim"], m["d_ff"])
    attn = d * H * hd + 2 * d * KV * hd + H * hd * d
    if m["ffn"] == "moe":
        ffn = d * m["n_experts"] + m["top_k"] * 3 * d * f
    else:
        ffn = 3 * d * f
    return m["n_layers"] * (attn + ffn) + d * m["vocab"]


def attn_flops_per_key(m: dict) -> int:
    return 4 * m["head_dim"] * m["n_heads"] * m["n_layers"]


def prefill_flops(m: dict, S: int) -> float:
    """One causal prompt of S tokens."""
    return 2.0 * n_active(m) * S + attn_flops_per_key(m) * S * (S + 1) / 2


def decode_flops(m: dict, keys: int) -> float:
    """One decoded token that attends ``keys`` keys (itself included)."""
    return 2.0 * n_active(m) + attn_flops_per_key(m) * keys


def generated_flops(m: dict, prompt_len: int, n_out: int) -> float:
    """The decode steps of a request whose first ``n_out`` tokens were
    served: the first comes from the prefill, token i > 0 from the step
    that feeds token i - 1 at position prompt_len + i - 1."""
    n = max(0, n_out - 1)
    keys = n * prompt_len + n * (n + 1) / 2
    return 2.0 * n_active(m) * n + attn_flops_per_key(m) * keys


def train_flops(m: dict, batch: int, seq: int) -> float:
    return 3.0 * batch * prefill_flops(m, seq)


def bound_s(flops: float, nbytes: float, dtype: str = "bfloat16") -> float:
    return max(flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES_S)


def flash_fwd_work(B: int, H: int, S: int, hd: int, el: int,
                   causal: bool = True) -> tuple[float, float]:
    """(FLOPs, bytes) of a forward over (B, H, S, hd) q, k, v → o."""
    pairs = S * (S + 1) / 2 if causal else S * S
    return 4.0 * B * H * hd * pairs, 4.0 * B * H * S * hd * el


def flash_bwd_work(B: int, H: int, S: int, hd: int, el: int,
                   causal: bool = True) -> tuple[float, float]:
    """(FLOPs, bytes) of dQ, dK, dV from q, k, v, o, dO and the row
    log-sum-exp (float32)."""
    pairs = S * (S + 1) / 2 if causal else S * S
    return (8.0 * B * H * hd * pairs,
            8.0 * B * H * S * hd * el + 4.0 * B * H * S)


def paged_decode_work(keys: list[int], H: int, KV: int, hd: int, el: int,
                      page: int) -> tuple[float, float]:
    """(FLOPs, bytes) of one decode-attention call: each sequence's q
    (H · hd) against its ``keys`` K/V rows, reading those rows and its live
    page-table entries, writing H · hd outputs."""
    k = sum(keys)
    pages = sum(-(-n // page) for n in keys)
    nbytes = (2.0 * k * KV * hd * el + 2.0 * len(keys) * H * hd * el
              + 4.0 * pages + 4.0 * len(keys))
    return 4.0 * k * H * hd, nbytes


def moe_dispatch_work(tokens: int, K: int, D: int,
                      el: int) -> tuple[float, float]:
    """Each token row read once, written to its K expert rows, with the
    (expert, row, weight) of each pair read."""
    return 0.0, tokens * D * el + tokens * K * (D * el + 12)


def moe_combine_work(tokens: int, K: int, D: int,
                     el: int) -> tuple[float, float]:
    """K expert rows and (expert, row, weight) read a token, one row
    written; a multiply-add per element of each row."""
    return 2.0 * tokens * K * D, tokens * K * (D * el + 12) + tokens * D * el
