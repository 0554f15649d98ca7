"""The port's CUDA kernels against their plain PyTorch versions on the
card.  Imports only torch and the port, so it runs where the JAX
reference is not installed:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_kernels_gpu.py

Without a CUDA device every test skips (the kernels have no CPU mode).
Tolerances: paged decode float32 atol 2e-5 (the same f32 online softmax,
summed in another order), bfloat16 atol 2e-2 (bf16 rounding of the
gather's einsums and of the output); MoE dispatch/combine float32 atol
1e-5, bfloat16 atol 5e-2 (the reference's kernel-test tolerances: the
kernels form products in f32 and cast once, the slot versions multiply
in bf16).
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import moe as mk
from repro_torch.kernels import ops
from repro_torch.kernels import paged_attention as pk
from repro_torch.nn import moe as nn_moe

pytestmark = pytest.mark.gpu

CASES = [
    # B, KV, G, hd, ps, P, window, softcap
    (2, 2, 2, 64, 4, 4, None, None),
    (2, 1, 4, 32, 8, 3, 5, 30.0),
    (1, 4, 1, 16, 4, 3, None, 50.0),
    (3, 2, 4, 32, 4, 5, 7, None),
    (2, 8, 6, 128, 16, 4, None, None),
    (2, 4, 2, 256, 16, 4, 20, 50.0),
    (4, 16, 1, 128, 16, 4, None, None),     # OLMoE: plain MHA, G=1
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc: the kernel has no CPU mode")
    return torch.device("cuda")


def _inputs(B, KV, G, hd, ps, P, dtype, device):
    r = np.random.default_rng(0)
    N = 1 + B * P
    q = torch.from_numpy(r.standard_normal((B, KV, G, hd), np.float32))
    kp = torch.from_numpy(r.standard_normal((N, ps, KV, hd), np.float32))
    vp = torch.from_numpy(r.standard_normal((N, ps, KV, hd), np.float32))
    table = torch.from_numpy(
        (1 + r.permutation(B * P)).reshape(B, P).astype(np.int32))
    if B == 3:
        table[2] = pk.SCRATCH_PAGE        # inactive slot on the scratch page
    q_pos = torch.tensor([ps * P - 1, ps + 1, 0, ps * P // 2][:B],
                         dtype=torch.int32)
    return ([t.to(device, dtype) for t in (q, kp, vp)]
            + [table.to(device), q_pos.to(device)])


@pytest.mark.parametrize("dtype,atol", [(torch.float32, 2e-5),
                                        (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("B,KV,G,hd,ps,P,window,sc", CASES)
def test_paged_decode_kernel_matches_gather(cuda, dtype, atol, B, KV, G, hd,
                                            ps, P, window, sc):
    args = _inputs(B, KV, G, hd, ps, P, dtype, cuda)
    n0 = pk.paged_decode_cuda.launches
    got = ops.paged_attention_decode(*args, window=window, softcap=sc)
    want = ops.paged_attention_decode(*args, window=window, softcap=sc,
                                      impl="gather")
    torch.cuda.synchronize()
    assert pk.paged_decode_cuda.launches == n0 + 1
    assert bool(torch.isfinite(got.float()).all())
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=0)


def test_kernel_smem_fits_every_supported_shape(cuda):
    # llama (G4 hd64), internlm2 (G6 hd128), chatglm3 (G16 hd128), gemma2
    # (G2/G4 hd256) and G16 hd256 at page size 16: each block's shared
    # memory is accepted by the card (G16 hd256 is above the default
    # 48 KiB), and the result still matches the gather (float32 atol 2e-5)
    for G, hd in [(4, 64), (6, 128), (16, 128), (4, 256), (16, 256)]:
        args = _inputs(1, 1, G, hd, 16, 2, torch.float32, cuda)
        got = pk.paged_decode_cuda(*args)
        want = pk.paged_decode_gather(*args)
        torch.testing.assert_close(got, want, atol=2e-5, rtol=0)


def test_paged_decode_kernel_rejects_what_it_does_not_take(cuda):
    args = _inputs(2, 2, 2, 64, 4, 4, torch.float32, cuda)
    with pytest.raises(ValueError, match="head_dim"):
        bad = [a[..., :48].contiguous() if i < 3 else a
               for i, a in enumerate(args)]
        pk.paged_decode_cuda(*bad)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        pk.paged_decode_cuda(*[a.half() if i < 3 else a
                               for i, a in enumerate(args)])
    with pytest.raises(ValueError, match="one dtype"):
        pk.paged_decode_cuda(args[0].bfloat16(), *args[1:])
    with pytest.raises(ValueError, match="contiguous"):
        pk.paged_decode_cuda(args[0].transpose(1, 2).contiguous()
                             .transpose(1, 2), *args[1:])


def test_paged_decode_kernel_refuses_autograd(cuda):
    args = _inputs(2, 2, 2, 64, 4, 4, torch.float32, cuda)
    q = args[0].clone().requires_grad_(True)
    with pytest.raises(RuntimeError, match="training slice"):
        pk.paged_decode_cuda(q, *args[1:])
    with torch.no_grad():
        pk.paged_decode_cuda(q, *args[1:])


# --------------------------------------------------------------------------
# MoE dispatch / combine
# --------------------------------------------------------------------------

MOE_CASES = [
    # G, S, D, E, K, cf
    (2, 24, 16, 4, 2, 1.25),
    (1, 64, 32, 8, 2, 1.0),
    (2, 32, 16, 4, 1, 0.25),          # heavy drops
    (1, 8, 16, 4, 4, 8.0),            # top_k = E
    (2, 24, 18, 4, 2, 1.25),          # D not a multiple of the vector width
    (4, 1, 2048, 64, 8, 1.25),        # OLMoE decode: C 8
    (1, 512, 2048, 64, 8, 1.25),      # OLMoE 512-token prefill: C 80
]
MOE_TOL = {torch.float32: 1e-5, torch.bfloat16: 5e-2}


def _moe_inputs(G, S, D, E, K, cf, dtype, device):
    """Routing from the port's moe_route on seeded numpy tokens and
    router, as moe_ffn builds it."""
    r = np.random.default_rng(G * 1000 + S + D)
    x = torch.from_numpy(r.standard_normal((G, S, D), np.float32)).to(device)
    router = torch.from_numpy(
        (r.standard_normal((D, E)) / np.sqrt(D)).astype(np.float32)).to(device)
    C = nn_moe.moe_capacity(S, E, K, cf)
    _, gate, eid, pos, keep = nn_moe.moe_route(router, x, top_k=K,
                                               capacity=C)
    nk = mk.slot_maps(eid, pos, keep, num_experts=E, capacity=C)
    src = mk.slot_sources(nk, top_k=K)
    sw = mk.slot_weights(nk, keep.to(torch.float32))
    w = (gate.reshape(G, S * K) * keep).reshape(G, S, K)
    safe = torch.where(keep, pos, 0).reshape(G, S, K)
    return x.to(dtype), src, sw, eid.reshape(G, S, K), safe, w, C


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("G,S,D,E,K,cf", MOE_CASES)
def test_moe_kernels_match_slot_versions(cuda, dtype, G, S, D, E, K, cf):
    x, src, sw, eid, pos, w, C = _moe_inputs(G, S, D, E, K, cf, dtype, cuda)
    n = (mk.moe_dispatch_cuda.launches, mk.moe_combine_cuda.launches)
    buf = mk.moe_dispatch_cuda(x, src, sw)
    want = mk.dispatch_slot(x, src, sw)
    torch.cuda.synchronize()
    assert buf.shape == (G, E, C, D) and buf.dtype == dtype
    torch.testing.assert_close(buf.float(), want.float(),
                               atol=MOE_TOL[dtype], rtol=0)
    y = mk.moe_combine_cuda(buf, eid, pos, w)
    want = mk.combine_slot(buf, eid, pos, w)
    torch.cuda.synchronize()
    assert y.shape == (G, S, D) and y.dtype == dtype
    torch.testing.assert_close(y.float(), want.float(), atol=MOE_TOL[dtype],
                               rtol=0)
    assert (mk.moe_dispatch_cuda.launches,
            mk.moe_combine_cuda.launches) == (n[0] + 1, n[1] + 1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("G,S,D,E,K,cf", [MOE_CASES[0], MOE_CASES[4],
                                          MOE_CASES[5]])
def test_moe_combine_reads_a_strided_slab(cuda, dtype, G, S, D, E, K, cf):
    """The expert product leaves its (G, E, C, D) output as a view of
    (E, G, C, D) storage; combine reads it through its strides, with no
    copy, and agrees with the plain version on the contiguous slab."""
    x, src, sw, eid, pos, w, C = _moe_inputs(G, S, D, E, K, cf, dtype, cuda)
    buf = mk.dispatch_slot(x, src, sw)
    strided = buf.transpose(0, 1).contiguous().transpose(0, 1)
    assert not strided.is_contiguous()
    got = mk.moe_combine_cuda(strided, eid, pos, w)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(),
                               mk.combine_slot(buf, eid, pos, w).float(),
                               atol=MOE_TOL[dtype], rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_moe_kernels_clamp_out_of_range_indices(cuda, dtype):
    """Source rows, expert ids and positions outside the arrays (negative
    or past the end) are clamped into them, as the plain versions clamp,
    and never read out of bounds."""
    g = torch.Generator(device="cuda").manual_seed(5)
    G, S, D, E, C, K = 2, 7, 64, 4, 8, 3
    x = torch.randn((G, S, D), generator=g, device=cuda).to(dtype)
    src = torch.randint(-3, S + 4, (G, E, C), generator=g, device=cuda,
                        dtype=torch.int32)
    # weights as the model makes them: in [0, 1], a token's gates summing
    # to 1 (the range bfloat16's tolerance is stated for)
    sw = torch.rand((G, E, C), generator=g, device=cuda)
    torch.testing.assert_close(mk.moe_dispatch_cuda(x, src, sw).float(),
                               mk.dispatch_slot(x, src, sw).float(),
                               atol=MOE_TOL[dtype], rtol=0)
    buf = torch.randn((G, E, C, D), generator=g, device=cuda).to(dtype)
    eid = torch.randint(-2, E + 3, (G, S, K), generator=g, device=cuda,
                        dtype=torch.int32)
    pos = torch.randint(-2, C + 5, (G, S, K), generator=g, device=cuda,
                        dtype=torch.int32)
    w = torch.rand((G, S, K), generator=g, device=cuda)
    w = w / w.sum(-1, keepdim=True)
    got = mk.moe_combine_cuda(buf, eid, pos, w)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(),
                               mk.combine_slot(buf, eid, pos, w).float(),
                               atol=MOE_TOL[dtype], rtol=0)


def test_moe_dispatch_empty_slot_is_zero_times_row_zero(cuda):
    x = torch.ones((1, 3, 8), device=cuda)
    x[0, 0, 1] = float("inf")
    src = torch.tensor([[[-1, 2]]], dtype=torch.int32, device=cuda)
    sw = torch.tensor([[[0.0, 1.0]]], device=cuda)
    got = mk.moe_dispatch_cuda(x, src, sw)
    want = mk.dispatch_slot(x, src, sw)
    assert torch.isnan(got[0, 0, 0, 1])
    torch.testing.assert_close(got, want, equal_nan=True, atol=0, rtol=0)


def test_moe_ffn_through_the_kernels_matches_slot_and_ref(cuda):
    r = np.random.default_rng(9)
    G, S, D, E, K, f = 2, 40, 64, 8, 2, 96
    p = {"router": r.standard_normal((D, E)) / np.sqrt(D),
         "w1": r.standard_normal((E, D, f)) / np.sqrt(D),
         "w3": r.standard_normal((E, D, f)) / np.sqrt(D),
         "w2": r.standard_normal((E, f, D)) / np.sqrt(f)}
    p = {k: torch.from_numpy(v.astype(np.float32)).to(cuda)
         for k, v in p.items()}
    x = torch.from_numpy(r.standard_normal((G, S, D), np.float32)).to(cuda)
    n = mk.moe_dispatch_cuda.launches
    y, aux = nn_moe.moe_ffn(p, x, top_k=K)
    assert mk.moe_dispatch_cuda.launches == n + 1
    for impl in ("slot", "ref"):
        y2, aux2 = nn_moe.moe_ffn(p, x, top_k=K, impl=impl)
        torch.testing.assert_close(y, y2, atol=1e-5, rtol=0)
        assert float(aux["dropped"]) == float(aux2["dropped"])


def test_moe_kernels_refuse_autograd(cuda):
    x, src, sw, eid, pos, w, _ = _moe_inputs(2, 24, 16, 4, 2, 1.25,
                                             torch.float32, cuda)
    with pytest.raises(RuntimeError, match="training slice"):
        mk.moe_dispatch_cuda(x.clone().requires_grad_(True), src, sw)
    buf = mk.moe_dispatch_cuda(x, src, sw)
    with pytest.raises(RuntimeError, match="training slice"):
        mk.moe_combine_cuda(buf, eid, pos, w.clone().requires_grad_(True))
    with torch.no_grad():
        mk.moe_combine_cuda(buf.clone().requires_grad_(True), eid, pos, w)


def test_moe_kernels_reject_what_they_do_not_take(cuda):
    x, src, sw, eid, pos, w, _ = _moe_inputs(2, 24, 16, 4, 2, 1.25,
                                             torch.float32, cuda)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        mk.moe_dispatch_cuda(x.half(), src, sw)
    with pytest.raises(ValueError, match="int32"):
        mk.moe_dispatch_cuda(x, src.long(), sw)
    with pytest.raises(ValueError, match="contiguous"):
        mk.moe_dispatch_cuda(x.transpose(0, 1).contiguous().transpose(0, 1),
                             src, sw)
    buf = mk.moe_dispatch_cuda(x, src, sw)
    with pytest.raises(ValueError, match="eid/pos/w"):
        mk.moe_combine_cuda(buf, eid, pos[..., :1].contiguous(), w)
    with pytest.raises(ValueError, match="last axis"):
        mk.moe_combine_cuda(buf.transpose(2, 3).contiguous().transpose(2, 3),
                            eid, pos, w)
