"""The yardstick's FLOP and byte counts against counts made by hand at
small shapes."""

import pytest

import _tiny  # noqa: F401
from harness import flops

DENSE = {"n_layers": 2, "d_model": 8, "n_heads": 4, "n_kv_heads": 2,
         "head_dim": 2, "vocab": 10, "ffn": "dense", "d_ff": 6}
MOE = {**DENSE, "ffn": "moe", "n_experts": 4, "top_k": 2}


def test_active_parameters_by_hand():
    # per layer: wq 8x8, wk and wv 8x4 each, wo 8x8, FFN 3 x 8x6; head 8x10
    assert flops.n_active(DENSE) == 2 * (64 + 32 + 32 + 64 + 144) + 80
    # MoE: router 8x4 and two of the four experts' 3 x 8x6
    assert flops.n_active(MOE) == 2 * (192 + 32 + 2 * 144) + 80


def test_prefill_and_decode_flops_by_hand():
    n = flops.n_active(DENSE)
    # 3 tokens: 2n each; keys attended 1 + 2 + 3, each 4 * hd * H * L
    assert flops.prefill_flops(DENSE, 3) == 2 * n * 3 + 4 * 2 * 4 * 2 * 6
    assert flops.decode_flops(DENSE, 5) == 2 * n + 4 * 2 * 4 * 2 * 5
    # 4 served tokens after a 3-token prompt: 3 decode steps feeding
    # positions 3, 4, 5, attending 4, 5, 6 keys
    assert flops.generated_flops(DENSE, 3, 4) == sum(
        flops.decode_flops(DENSE, k) for k in (4, 5, 6))
    assert flops.generated_flops(DENSE, 3, 1) == 0
    assert flops.train_flops(DENSE, 2, 3) == 3 * 2 * flops.prefill_flops(
        DENSE, 3)


def test_kernel_work_by_hand():
    # flash forward, B1 H2 S3 hd4, bf16: 6 causal pairs, 2 products of
    # 2 * hd FLOPs each; q, k, v read and o written once
    assert flops.flash_fwd_work(1, 2, 3, 4, 2) == (4 * 2 * 4 * 6,
                                                   4 * 2 * 3 * 4 * 2)
    assert flops.flash_bwd_work(1, 2, 3, 4, 2) == (8 * 2 * 4 * 6,
                                                   8 * 2 * 3 * 4 * 2
                                                   + 4 * 2 * 3)
    # paged decode: sequences with 3 and 17 keys, KV 2, H 4, hd 8, bf16,
    # pages of 16 (1 + 2 pages)
    f, b = flops.paged_decode_work([3, 17], 4, 2, 8, 2, 16)
    assert f == 4 * 20 * 4 * 8
    assert b == 2 * 20 * 2 * 8 * 2 + 2 * 2 * 4 * 8 * 2 + 4 * 3 + 4 * 2
    # MoE: 5 tokens, top-2, D 8, bf16
    assert flops.moe_dispatch_work(5, 2, 8, 2) == (0, 5 * 16 + 10 * 28)
    assert flops.moe_combine_work(5, 2, 8, 2) == (2 * 5 * 2 * 8,
                                                  10 * 28 + 5 * 16)


def test_bound_is_the_larger_of_compute_and_bytes():
    assert flops.bound_s(989e12, 0) == pytest.approx(1.0)
    assert flops.bound_s(0, 3.35e12) == pytest.approx(1.0)
    assert flops.bound_s(989e9, 3.35e12) == pytest.approx(1.0)
