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
in bf16); flash attention forward float32 atol 2e-5 and bfloat16 atol
2e-2 (the reference's kernel-test tolerances), backward against autograd
of the plain version float32 atol 1e-4 rtol 1e-4 (sums over up to 2048
keys or rows in another order) and bfloat16 atol 5e-2 rtol 1.6e-2 (one
bf16 rounding of gradients of magnitude up to ~10 on each side, and D
formed from the bf16 output); embedding bag float32 atol 1e-5 and
bfloat16 atol 5e-2 (the reference's kernel-test tolerances: both sum in
f32, in another order), bag 1 bit-equal to a gather (``0 + row``), and
every path of the kernel bit-equal to ``embedding_bag_ordered`` (the sum
in the kernel's order); the CTR path on the card bit-equal to the same
path with the plain gather.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import embedding_bag as bk
from repro_torch.kernels import flash_attention as fk
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


#: the decode shapes of the full-width archs served on the card (4 slots,
#: page size 16): B, KV, G, hd, P, window, softcap, q_pos, dtype
ARCH_DECODE_CASES = [
    (4, 2, 16, 128, 35, None, None, [76, 200, 350, 551], torch.float32),
    (4, 4, 2, 256, 291, 4096, 50.0, [4639, 551, 300, 76], torch.float32),
    (4, 8, 6, 128, 35, None, None, [76, 200, 350, 551], torch.bfloat16),
    (4, 4, 8, 128, 35, None, None, [76, 200, 350, 551], torch.bfloat16),
    (4, 8, 4, 128, 35, None, None, [76, 200, 350, 551], torch.bfloat16),
    (4, 8, 4, 128, 35, None, None, [76, 200, 350, 551], torch.float32),
    (4, 20, 1, 64, 35, None, None, [76, 200, 350, 551], torch.float32),
]


@pytest.mark.parametrize("B,KV,G,hd,P,window,sc,q_pos,dtype",
                         ARCH_DECODE_CASES,
                         ids=["chatglm3", "gemma2", "internlm2", "qwen3-moe",
                              "jamba", "llama-vision", "whisper"])
def test_paged_decode_at_the_served_archs_decode_shapes(cuda, B, KV, G, hd,
                                                        P, window, sc, q_pos,
                                                        dtype):
    """chatglm3-6b (G 16) and gemma2-2b (G 2, hd 256, a sequence past its
    window of 4,096, soft cap 50) in float32, internlm2-20b (G 6) and
    qwen3-moe-30b-a3b (G 8) in bfloat16, jamba-v0.1-52b's attention
    layers (G 4) in bfloat16, llama-3.2-vision-11b's (G 4) and
    whisper-large-v3's decoder (KV 20, G 1, hd 64) in float32: against
    the gather (float32 atol 2e-5, bfloat16 2e-2) and bit-equal over two
    calls."""
    args = _split_inputs(B, KV, G, hd, 16, P, q_pos, dtype, cuda)
    got = pk.paged_decode_cuda(*args, window=window, softcap=sc)
    again = pk.paged_decode_cuda(*args, window=window, softcap=sc)
    want = pk.paged_decode_gather(*args, window=window, softcap=sc)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    torch.testing.assert_close(got.float(), want.float(), rtol=0,
                               atol=2e-5 if dtype == torch.float32 else 2e-2)


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
    with pytest.raises(RuntimeError, match="no backward kernel"):
        pk.paged_decode_cuda(q, *args[1:])
    with torch.no_grad():
        pk.paged_decode_cuda(q, *args[1:])


#: B, KV, G, hd, ps, P, window, softcap, q_pos: the split over KV pages
#: (B2 KV2 on a 40- or 37-page table: 10 splits of 4 pages on an H100) —
#: sequences across split boundaries, q_pos in the first split, a window
#: that starts mid-split, P that does not divide into the splits, one
#: sequence over 16 splits at G 16, and the timed shape (B8 KV8, 128
#: pages, 9 splits) with a window and softcap
SPLIT_CASES = [
    (2, 2, 4, 64, 16, 40, None, None, [639, 300]),
    (2, 2, 4, 64, 16, 40, None, None, [20, 63]),
    (2, 2, 4, 64, 16, 40, 90, None, [500, 300]),
    (2, 2, 4, 64, 16, 37, 50, 30.0, [591, 100]),
    (1, 1, 16, 128, 16, 64, 700, None, [1000]),
    (8, 8, 4, 64, 16, 128, 300, 50.0,
     [2047, 1500, 1023, 700, 333, 64, 15, 0]),
]


def _split_inputs(B, KV, G, hd, ps, P, q_pos, dtype, device):
    r = np.random.default_rng(1)
    N = 1 + B * P
    q = torch.from_numpy(r.standard_normal((B, KV, G, hd), np.float32))
    kp = torch.from_numpy(r.standard_normal((N, ps, KV, hd), np.float32))
    vp = torch.from_numpy(r.standard_normal((N, ps, KV, hd), np.float32))
    table = torch.from_numpy(
        (1 + r.permutation(B * P)).reshape(B, P).astype(np.int32))
    return ([t.to(device, dtype) for t in (q, kp, vp)]
            + [table.to(device), torch.tensor(q_pos, dtype=torch.int32,
                                              device=device)])


@pytest.mark.parametrize("dtype,atol", [(torch.float32, 2e-5),
                                        (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("B,KV,G,hd,ps,P,window,sc,q_pos", SPLIT_CASES)
def test_paged_decode_split_over_pages_matches_gather(cuda, dtype, atol, B, KV,
                                                      G, hd, ps, P, window,
                                                      sc, q_pos):
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    splits, pps = pk.decode_splits(B, KV, P, sms)
    assert splits > 1
    args = _split_inputs(B, KV, G, hd, ps, P, q_pos, dtype, cuda)
    n0 = pk.paged_decode_cuda.launches
    got = pk.paged_decode_cuda(*args, window=window, softcap=sc)
    again = pk.paged_decode_cuda(*args, window=window, softcap=sc)
    want = pk.paged_decode_gather(*args, window=window, softcap=sc)
    torch.cuda.synchronize()
    assert pk.paged_decode_cuda.launches == n0 + 2
    assert torch.equal(got, again)
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=0)


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
    (4, 1, 2048, 128, 8, 1.25),       # qwen3-moe decode: C 8
    (1, 512, 2048, 128, 8, 1.25),     # qwen3-moe 512-token prefill: C 40
    (4, 1, 4096, 16, 2, 1.25),        # jamba decode: C 8
    (1, 512, 4096, 16, 2, 1.25),      # jamba 512-token prefill: C 80
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


#: (label, G, S, D, E, K, cf, dtype, layout): every path of both kernels
#: (dispatch: tiles of 8 slots for groups under 8 tokens, else 4; combine:
#: one-warp blocks when the blocks are few, else four-warp blocks).
#: layout: "contiguous"; "strided", the slab as the expert product leaves
#: it (a (G, E, C, D) view of (E, G, C, D) storage); "odd strides", a slab
#: whose g/e/c strides are not multiples of 4; "misaligned", x and the slab
#: starting one element into their storage (4 or 2 bytes off 16)
MOE_PATH_CASES = [
    ("olmoe decode", 4, 1, 2048, 64, 8, 1.25, torch.float32, "contiguous"),
    ("olmoe decode", 4, 1, 2048, 64, 8, 1.25, torch.float32, "strided"),
    ("olmoe decode", 4, 1, 2048, 64, 8, 1.25, torch.bfloat16, "contiguous"),
    ("olmoe decode", 4, 1, 2048, 64, 8, 1.25, torch.bfloat16, "misaligned"),
    ("decode D 2046", 4, 1, 2046, 64, 8, 1.25, torch.float32, "contiguous"),
    ("groups of 5 tokens, partial tile", 3, 5, 256, 6, 2, 1.0,
     torch.float32, "contiguous"),
    ("olmoe prefill", 1, 512, 2048, 64, 8, 1.25, torch.float32,
     "contiguous"),
    ("olmoe prefill", 1, 512, 2048, 64, 8, 1.25, torch.float32, "strided"),
    ("D 2046", 2, 24, 2046, 8, 2, 1.25, torch.float32, "contiguous"),
    ("D 2044", 2, 24, 2044, 8, 2, 1.25, torch.bfloat16, "contiguous"),
    ("partial column chunk", 2, 24, 1500, 8, 2, 1.25, torch.float32,
     "contiguous"),
    ("misaligned", 2, 24, 256, 8, 2, 1.25, torch.float32, "misaligned"),
    ("misaligned", 2, 24, 256, 8, 2, 1.25, torch.bfloat16, "misaligned"),
    ("odd strides", 2, 24, 64, 8, 2, 1.25, torch.float32, "odd strides"),
    ("odd strides", 2, 24, 64, 8, 2, 1.25, torch.bfloat16, "odd strides"),
    ("K 1", 2, 32, 128, 8, 1, 1.25, torch.float32, "contiguous"),
    ("K 8 = E", 1, 16, 128, 8, 8, 2.0, torch.float32, "contiguous"),
    ("K 12 E 16", 2, 20, 128, 16, 12, 1.25, torch.float32, "contiguous"),
    ("K 12 E 16", 2, 20, 128, 16, 12, 1.25, torch.bfloat16, "strided"),
    ("K 40 E 64", 1, 16, 64, 64, 40, 1.25, torch.float32, "contiguous"),
    ("drops cf 0.25", 2, 32, 128, 4, 1, 0.25, torch.float32, "contiguous"),
]


def _moe_layout(t, layout, permuted):
    """``t`` (contiguous) laid out as ``layout`` asks, same values."""
    if layout == "misaligned":
        base = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
        out = base[1:].view(t.shape).copy_(t)
        assert out.is_contiguous() and out.data_ptr() % 16
        return out
    if layout == "strided" and permuted:
        # with G = 1 (a prefill's one routing group) the view is contiguous
        out = t.transpose(0, 1).contiguous().transpose(0, 1)
        assert t.shape[0] == 1 or not out.is_contiguous()
        return out
    if layout == "odd strides" and permuted:
        G, E, C, D = t.shape       # D even: every stride below is odd
        sc = D + 1
        sg = C * sc + 1
        se = G * sg + 1
        st = torch.empty(E * se, dtype=t.dtype, device=t.device)
        out = st.as_strided((G, E, C, D), (sg, se, sc, 1))
        out.copy_(t)
        assert all(s % 4 for s in out.stride()[:3])
        return out
    return t


@pytest.mark.parametrize("label,G,S,D,E,K,cf,dtype,layout", MOE_PATH_CASES)
def test_moe_kernels_bit_equal_on_every_path(cuda, label, G, S, D, E, K, cf,
                                             dtype, layout):
    """Each path of both kernels (fast and fallback, every K group, drops)
    against the plain versions: dispatch bit-equal to ``dispatch_slot``
    formed in float32 and cast once; combine bit-equal to
    ``combine_slot_ordered`` (k in order into a float32 accumulator, cast
    once); bfloat16 also within 5e-2 of the slot versions; each call one
    launch; both bit-equal on repeat."""
    x, src, sw, eid, pos, w, C = _moe_inputs(G, S, D, E, K, cf, dtype, cuda)
    x = _moe_layout(x, layout, permuted=False)
    n = (mk.moe_dispatch_cuda.launches, mk.moe_combine_cuda.launches)
    buf = mk.moe_dispatch_cuda(x, src, sw)
    assert mk.moe_dispatch_cuda.launches == n[0] + 1
    want = mk.dispatch_slot(x.float(), src, sw).to(dtype)
    torch.cuda.synchronize()
    assert buf.shape == (G, E, C, D) and torch.equal(buf, want), label
    torch.testing.assert_close(buf.float(), mk.dispatch_slot(x, src,
                                                             sw).float(),
                               atol=MOE_TOL[dtype], rtol=0)
    assert torch.equal(mk.moe_dispatch_cuda(x, src, sw), buf)

    slab = _moe_layout(buf, layout, permuted=True)
    y = mk.moe_combine_cuda(slab, eid, pos, w)
    assert mk.moe_combine_cuda.launches == n[1] + 1
    torch.cuda.synchronize()
    assert y.shape == (G, S, D)
    assert torch.equal(y, mk.combine_slot_ordered(buf, eid, pos, w)), label
    torch.testing.assert_close(y.float(),
                               mk.combine_slot(buf, eid, pos, w).float(),
                               atol=MOE_TOL[dtype], rtol=0)
    assert torch.equal(mk.moe_combine_cuda(slab, eid, pos, w), y)


def test_chip_smoke_baseline_launches_the_earlier_build(cuda, tmp_path):
    """``chip_smoke.py --baseline``: an earlier kernel source, built beside
    the kernels, is what the wrappers launch inside ``earlier_kernels``,
    and the current build is again after it (here the earlier source is
    the current ``moe.cu`` with a comment appended, so the bits agree)."""
    import ctypes
    import sys
    from pathlib import Path

    from repro_torch.kernels import _build

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke

    def addr(fn):
        return ctypes.cast(fn, ctypes.c_void_p).value

    old = tmp_path / "moe.cu"
    old.write_text((_build.CSRC / "moe.cu").read_text() + "// earlier\n")
    libs = chip_smoke.build_earlier([str(old)])
    x, src, sw, eid, pos, w, _ = _moe_inputs(4, 1, 2048, 64, 8, 1.25,
                                             torch.float32, cuda)
    want = mk.moe_dispatch_cuda(x, src, sw)
    current = _build.load("moe")
    with chip_smoke.earlier_kernels({"moe": mk}, libs):
        assert _build.load("moe") is libs["moe"] is not current
        assert addr(mk._kernel_fns()[0]) == addr(libs["moe"].moe_dispatch)
        got = mk.moe_dispatch_cuda(x, src, sw)
    assert _build.load("moe") is current
    assert addr(mk._kernel_fns()[0]) == addr(current.moe_dispatch)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


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
    with pytest.raises(RuntimeError, match="MoeDispatch / MoeCombine"):
        mk.moe_dispatch_cuda(x.clone().requires_grad_(True), src, sw)
    buf = mk.moe_dispatch_cuda(x, src, sw)
    with pytest.raises(RuntimeError, match="MoeDispatch / MoeCombine"):
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


def _moe_routing(G, S, D, E, K, cf, device):
    """Tokens and ``moe_ffn``'s routing as the Functions take it: the flat
    (G, S·K) eid/pos and keep mask, and (G, S, K) safe_pos and gates."""
    r = np.random.default_rng(G * 100 + S)
    x = torch.from_numpy(r.standard_normal((G, S, D), np.float32)).to(device)
    router = torch.from_numpy(
        (r.standard_normal((D, E)) / np.sqrt(D)).astype(np.float32)).to(device)
    C = nn_moe.moe_capacity(S, E, K, cf)
    _, gate, eid, pos, keep = nn_moe.moe_route(router, x, top_k=K,
                                               capacity=C)
    w = (gate.reshape(G, S * K) * keep).reshape(G, S, K)
    safe = torch.where(keep, pos, 0).reshape(G, S, K)
    return x, eid, pos, keep, safe, w, C


@pytest.mark.parametrize("G,S,D,E,K,cf", [MOE_CASES[0], MOE_CASES[2],
                                          MOE_CASES[3], MOE_CASES[6]])
def test_moe_functions_gradients_match_slot_autograd(cuda, G, S, D, E, K,
                                                     cf):
    """dx through MoeDispatch (combine kernel) and dbuf / dw through
    MoeCombine (dispatch kernel + gather-dot) against autograd of the slot
    versions, float32 atol 1e-5 (dw 1e-4: a dot over D in another order);
    wtok gets a zero gradient.  dw of a dropped pair is 0, as the
    reference's backward masks it by keep; autograd of the slot version
    leaves the unused dot there (the model multiplies it by keep = 0)."""
    x, eid, pos, keep, safe, w, C = _moe_routing(G, S, D, E, K, cf, cuda)
    r = np.random.default_rng(3)
    wtok = keep.to(torch.float32)
    n = (mk.moe_dispatch_cuda.launches, mk.moe_combine_cuda.launches)

    def run(impl):
        xi = x.clone().requires_grad_(True)
        wt = wtok.clone().requires_grad_(True)
        buf = ops.moe_dispatch(xi, eid, pos, wt, num_experts=E, capacity=C,
                               top_k=K, impl=impl)
        g_buf = torch.from_numpy(
            r.standard_normal(tuple(buf.shape), np.float32)).to(cuda)
        (dx, dwt) = torch.autograd.grad(buf, (xi, wt), g_buf,
                                        allow_unused=True)
        b = buf.detach().clone().requires_grad_(True)
        wi = w.clone().requires_grad_(True)
        y = ops.moe_combine(b, eid.reshape(G, S, K), safe, wi, impl=impl)
        g_y = torch.from_numpy(
            r.standard_normal(tuple(y.shape), np.float32)).to(cuda)
        dbuf, dw = torch.autograd.grad(y, (b, wi), g_y)
        return dx, dwt, dbuf, dw

    got = run("cuda")
    assert mk.moe_dispatch_cuda.launches == n[0] + 2   # fwd + combine's bwd
    assert mk.moe_combine_cuda.launches == n[1] + 2    # fwd + dispatch's bwd
    r = np.random.default_rng(3)
    want = run("slot")
    torch.cuda.synchronize()
    assert got[1] is not None and not got[1].any()
    kept = keep.reshape(G, S, K)
    assert not got[3][~kept].any()
    want = (*want[:3], torch.where(kept, want[3], 0.0))
    for name, a, b, atol in zip(("dx", "dbuf", "dw"),
                                (got[0], got[2], got[3]),
                                (want[0], want[2], want[3]),
                                (1e-5, 1e-5, 1e-4)):
        torch.testing.assert_close(a, b, atol=atol, rtol=0, msg=name)


def _bf16_ulps(t, n=4):
    """``n`` bfloat16 ulps at the largest |value| of ``t``."""
    top = t.float().abs().max().item()
    return n * 2.0 ** (np.floor(np.log2(top)) - 7)


@pytest.mark.parametrize("G,S,E", [(1, 512, 64), (2, 2048, 64),
                                   (1, 512, 128)],
                         ids=["olmoe prefill", "olmoe train", "qwen3 prefill"])
def test_moe_functions_bf16_gradients_match_slot_autograd(cuda, G, S, E):
    """bfloat16 dx / dbuf / dw through the MoE Functions against autograd
    of the slot versions, each within 4 bfloat16 ulps of its largest
    |value|: the kernels form products in float32 and round once, the
    slot versions multiply and accumulate in bfloat16."""
    D, K = 2048, 8
    x, eid, pos, keep, safe, w, C = _moe_routing(G, S, D, E, K, 1.25, cuda)
    x, w = x.to(torch.bfloat16), w.to(torch.bfloat16)
    wtok = keep.to(torch.float32)
    r = np.random.default_rng(4)
    g_buf = torch.from_numpy(r.standard_normal((G, E, C, D), np.float32)).to(
        cuda, torch.bfloat16)
    g_y = torch.from_numpy(r.standard_normal((G, S, D), np.float32)).to(
        cuda, torch.bfloat16)

    def run(impl):
        xi = x.clone().requires_grad_(True)
        buf = ops.moe_dispatch(xi, eid, pos, wtok, num_experts=E, capacity=C,
                               top_k=K, impl=impl)
        (dx,) = torch.autograd.grad(buf, (xi,), g_buf)
        b = buf.detach().clone().requires_grad_(True)
        wi = w.clone().requires_grad_(True)
        y = ops.moe_combine(b, eid.reshape(G, S, K), safe, wi, impl=impl)
        dbuf, dw = torch.autograd.grad(y, (b, wi), g_y)
        return dx, dbuf, torch.where(keep.reshape(G, S, K), dw, 0.0)

    got, want = run("cuda"), run("slot")
    torch.cuda.synchronize()
    for name, a, b in zip(("dx", "dbuf", "dw"), got, want):
        assert a.dtype == torch.bfloat16, name
        torch.testing.assert_close(a.float(), b.float(), rtol=0,
                                   atol=_bf16_ulps(b), msg=name)


# --------------------------------------------------------------------------
# flash attention
# --------------------------------------------------------------------------

#: B, H, Sq, Sk, hd, causal, window, softcap: the reference sweep
#: (tests/test_kernels.py), partial tiles, llama3.2-1b's training shape cut
#: to one microbatch row and 4 heads, head dim 32 (the reduced
#: llama3.2-1b's shape, and ragged with every mask), and the encoder and
#: cross-attention shapes of whisper-large-v3 and llama-3.2-vision-11b
#: (non-causal over 1,500 frames; 512 queries over 1,500 / 1,601 keys)
FLASH_CASES = [
    (1, 1, 128, 128, 64, True, None, None),
    (2, 2, 256, 256, 64, True, None, None),
    (1, 2, 384, 384, 128, True, None, None),
    (1, 1, 128, 128, 256, True, None, None),
    (1, 2, 256, 256, 64, True, 32, None),
    (1, 2, 256, 256, 64, True, 100, None),
    (1, 2, 256, 256, 64, True, 128, None),
    (1, 1, 128, 128, 64, True, None, 50.0),
    (2, 1, 128, 256, 64, False, None, None),
    (1, 2, 128, 384, 64, False, None, None),
    (1, 2, 77, 77, 64, True, None, None),          # one partial tile
    (1, 2, 300, 300, 128, True, 40, 30.0),         # partial tile, all masks
    (1, 2, 100, 100, 256, False, 20, None),        # window, non-causal
    (1, 4, 2048, 2048, 64, True, None, None),      # llama training length
    (1, 2, 256, 128, 64, False, 20, None),         # rows 147.. see no key
    (1, 2, 200, 64, 128, True, 16, 30.0),          # rows 79.. see no key
    (2, 8, 128, 128, 32, True, None, None),        # reduced llama3.2-1b
    (1, 2, 200, 200, 32, True, 16, 30.0),          # hd 32, ragged, all masks
    (1, 16, 2048, 2048, 128, True, None, None),    # olmoe / chatglm3 training
    (1, 8, 4608, 4608, 256, True, 4096, 50.0),     # gemma2 past its window
    (4, 20, 1500, 1500, 64, False, None, None),    # whisper encoder
    (4, 20, 512, 1500, 64, False, None, None),     # whisper cross
    (4, 32, 512, 1601, 128, False, None, None),    # llama-vision cross
]
FLASH_FWD_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
FLASH_BWD_TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (5e-2, 1.6e-2)}


def _flash_inputs(B, H, Sq, Sk, hd, dtype, device, seed=0):
    r = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(r.standard_normal(s, np.float32)).to(
        device, dtype) for s in ((B, H, Sq, hd), (B, H, Sk, hd),
                                 (B, H, Sk, hd)))
    do = torch.from_numpy(r.standard_normal((B, H, Sq, hd), np.float32)).to(
        device, dtype)
    return q, k, v, do


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,Sq,Sk,hd,causal,window,cap", FLASH_CASES)
def test_flash_forward_matches_plain(cuda, dtype, B, H, Sq, Sk, hd, causal,
                                     window, cap):
    q, k, v, _ = _flash_inputs(B, H, Sq, Sk, hd, dtype, cuda)
    n = fk.flash_fwd_cuda.launches
    o, lse = fk.flash_fwd_cuda(q, k, v, causal=causal, window=window,
                               softcap=cap)
    want = fk.flash_attention_ref(q, k, v, causal=causal, window=window,
                                  softcap=cap)
    again = fk.flash_fwd_cuda(q, k, v, causal=causal, window=window,
                              softcap=cap)
    torch.cuda.synchronize()
    assert fk.flash_fwd_cuda.launches == n + 2
    assert torch.equal(o, again[0]) and torch.equal(lse, again[1])
    assert o.dtype == dtype and lse.shape == (B, H, Sq)
    assert bool(torch.isfinite(o.float()).all())
    torch.testing.assert_close(o.float(), want.float(),
                               atol=FLASH_FWD_TOL[dtype], rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,Sq,Sk,hd,causal,window,cap", FLASH_CASES)
def test_flash_backward_matches_plain_autograd(cuda, dtype, B, H, Sq, Sk, hd,
                                               causal, window, cap):
    q, k, v, do = _flash_inputs(B, H, Sq, Sk, hd, dtype, cuda)
    n = (fk.flash_bwd_dkdv_cuda.launches, fk.flash_bwd_dq_cuda.launches)

    def grads(fn):
        qkv = [t.clone().requires_grad_(True) for t in (q, k, v)]
        out = fn(*qkv, causal=causal, window=window, softcap=cap)
        return torch.autograd.grad(out, qkv, do)

    got = grads(fk.flash_attention_cuda)
    want = grads(fk.flash_attention_ref)
    torch.cuda.synchronize()
    assert (fk.flash_bwd_dkdv_cuda.launches,
            fk.flash_bwd_dq_cuda.launches) == (n[0] + 1, n[1] + 1)
    atol, rtol = FLASH_BWD_TOL[dtype]
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == dtype and bool(torch.isfinite(a.float()).all())
        torch.testing.assert_close(a.float(), b.float(), atol=atol, rtol=rtol,
                                   msg=name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,Sq,Sk,hd,causal,window,cap", [
    (1, 2, 256, 256, 256, True, None, None),       # hd 256
    (2, 2, 333, 333, 256, False, None, 20.0),      # hd 256, ragged, softcap
    (1, 3, 517, 517, 64, True, None, 30.0),        # ragged, softcap
    (1, 2, 190, 190, 128, True, 50, 25.0),         # ragged, softcap, window
])
def test_flash_backward_hd256_and_ragged_softcap(cuda, dtype, B, H, Sq, Sk,
                                                 hd, causal, window, cap):
    """The tensor-core backward at head dim 256 and at ragged lengths with
    a soft cap, against autograd of the plain version (FLASH_BWD_TOL), and
    the same bits from a second run."""
    q, k, v, do = _flash_inputs(B, H, Sq, Sk, hd, dtype, cuda, seed=3)
    kw = {"causal": causal, "window": window, "softcap": cap}

    def grads(fn):
        qkv = [t.clone().requires_grad_(True) for t in (q, k, v)]
        return torch.autograd.grad(fn(*qkv, **kw), qkv, do)

    got = grads(fk.flash_attention_cuda)
    again = grads(fk.flash_attention_cuda)
    want = grads(fk.flash_attention_ref)
    torch.cuda.synchronize()
    atol, rtol = FLASH_BWD_TOL[dtype]
    for name, a, b, c in zip(("dq", "dk", "dv"), got, want, again):
        assert torch.equal(a, c), name
        torch.testing.assert_close(a.float(), b.float(), atol=atol, rtol=rtol,
                                   msg=name)


def test_flash_backward_is_deterministic(cuda):
    q, k, v, do = _flash_inputs(2, 4, 512, 512, 64, torch.float32, cuda)
    qkv = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = fk.flash_attention_cuda(*qkv, causal=True)
    first = torch.autograd.grad(out, qkv, do, retain_graph=True)
    for _ in range(3):
        again = torch.autograd.grad(out, qkv, do, retain_graph=True)
        for a, b in zip(first, again):
            assert torch.equal(a, b)


def test_flash_ops_pads_as_the_reference(cuda):
    """ops.flash_attention hands a causal 200-token sequence to the kernels
    unpadded (one launch of each, at Sq = 200); forward and gradients
    agree with the plain version.  A non-causal Sk off the reference's
    block multiple, which the reference refuses, equals the plain version
    too."""
    q, k, v, do = _flash_inputs(1, 2, 200, 200, 64, torch.float32, cuda)
    qkv = [t.clone().requires_grad_(True) for t in (q, k, v)]
    n = fk.flash_fwd_cuda.launches
    out = ops.flash_attention(*qkv, causal=True)
    assert out.shape == q.shape and fk.flash_fwd_cuda.launches == n + 1
    got = torch.autograd.grad(out, qkv, do)
    qkv2 = [t.clone().requires_grad_(True) for t in (q, k, v)]
    ref = ops.flash_attention(*qkv2, causal=True, impl="ref")
    want = torch.autograd.grad(ref, qkv2, do)
    torch.testing.assert_close(out, ref, atol=2e-5, rtol=0)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)
    q1 = q[:, :, :128].contiguous()
    torch.testing.assert_close(
        ops.flash_attention(q1, k, v, causal=False),
        ops.flash_attention(q1, k, v, causal=False, impl="ref"),
        atol=2e-5, rtol=0)


def test_flash_kernels_reject_what_they_do_not_take(cuda):
    q, k, v, _ = _flash_inputs(1, 2, 64, 64, 64, torch.float32, cuda)
    with pytest.raises(ValueError, match="head_dim"):
        fk.flash_fwd_cuda(q[..., :48].contiguous(), k[..., :48].contiguous(),
                          v[..., :48].contiguous())
    with pytest.raises(ValueError, match="one dtype"):
        fk.flash_fwd_cuda(q, k.bfloat16(), v)
    with pytest.raises(ValueError, match="contiguous"):
        fk.flash_fwd_cuda(q.transpose(2, 3).contiguous().transpose(2, 3), k,
                          v)
    with pytest.raises(RuntimeError, match="FlashAttention"):
        fk.flash_fwd_cuda(q.clone().requires_grad_(True), k, v)


# --------------------------------------------------------------------------
# embedding bag
# --------------------------------------------------------------------------

BAG_CASES = [
    # N, bag, V, dim: the reference sweep, the CTR pulls, ragged widths
    (8, 4, 100, 128), (16, 1, 50, 128), (4, 16, 1000, 256),
    (6656, 1, 4096, 16), (256, 26, 200_000, 16),
    (7, 3, 50, 5), (33, 5, 64, 12), (9, 2, 300, 1000),
]
BAG_TOL = {torch.float32: 1e-5, torch.bfloat16: 5e-2}


def _bag_inputs(N, bag, V, dim, dtype, device, seed=0):
    r = np.random.default_rng(seed)
    ids = torch.from_numpy(r.integers(0, V, (N, bag)).astype(np.int32))
    table = torch.from_numpy(r.standard_normal((V, dim), np.float32))
    return ids.to(device), table.to(device, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("N,bag,V,dim", BAG_CASES)
def test_embedding_bag_kernel_matches_plain(cuda, dtype, N, bag, V, dim):
    ids, table = _bag_inputs(N, bag, V, dim, dtype, cuda)
    n = bk.embedding_bag_cuda.launches
    got = ops.embedding_bag(ids, table)
    want = ops.embedding_bag(ids, table, impl="ref")
    torch.cuda.synchronize()
    assert bk.embedding_bag_cuda.launches == n + 1
    assert got.dtype == dtype and got.shape == (N, dim)
    torch.testing.assert_close(got.float(), want.float(),
                               atol=BAG_TOL[dtype], rtol=0)
    if bag == 1:
        assert torch.equal(got, table[ids[:, 0].long()])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_embedding_bag_kernel_clamps_and_takes_int64(cuda, dtype):
    ids, table = _bag_inputs(64, 6, 40, 16, dtype, cuda)
    ids[::3, 1] = -5
    ids[1::3, 4] = 40 + 7
    ids64 = ids.long()
    ids64[5, 0] = 2 ** 40                         # past int32: clamps too
    for i in (ids, ids64):
        torch.testing.assert_close(
            bk.embedding_bag_cuda(i, table).float(),
            bk.embedding_bag_ref(i, table).float(),
            atol=BAG_TOL[dtype], rtol=0)
    dup = torch.zeros((4, 8), dtype=torch.int32, device=cuda)
    torch.testing.assert_close(bk.embedding_bag_cuda(dup, table.float()),
                               8 * table[0].float().expand(4, -1),
                               atol=0, rtol=1e-6)


#: (label, N, bag, V, dim, dtype, misaligned table): each path of the
#: kernel.  Staged (the launch's blocks all fit on the card at once): rows
#: of a multiple of 16 bytes, one stage (up to 64 rows) or a ring of two,
#: a warp a bag when the bags are few, several bags a warp otherwise, rows
#: wider than 512 bytes in column chunks; streamed (more bags than that);
#: the gather at bag 1; the fallbacks for a table view offset by one
#: element and for rows that are not a multiple of 16 bytes
BAG_PATH_CASES = [
    ("staged", 256, 26, 1000, 128, torch.float32, False),
    ("staged", 256, 26, 1000, 128, torch.bfloat16, False),
    ("staged, several bags a warp", 4096, 26, 20_000, 16, torch.float32,
     False),
    ("staged, several bags a warp", 4096, 26, 20_000, 16, torch.bfloat16,
     False),
    ("staged, a warp a bag", 8, 26, 500, 16, torch.float32, False),
    ("staged, column chunks", 9, 5, 300, 1000, torch.float32, False),
    ("staged, column chunks", 9, 5, 300, 1000, torch.bfloat16, False),
    ("ring, bag 70", 33, 70, 5000, 128, torch.float32, False),
    ("ring, bag 70", 33, 70, 5000, 128, torch.bfloat16, False),
    ("ring, bag 300", 17, 300, 5000, 16, torch.float32, False),
    ("ring, bag 300", 17, 300, 5000, 16, torch.bfloat16, False),
    ("ring, 16-byte rows, 32 bags a warp", 9000, 20, 1000, 4,
     torch.float32, False),
    ("streamed", 20_000, 26, 50_000, 128, torch.float32, False),
    ("streamed", 20_000, 26, 50_000, 128, torch.bfloat16, False),
    ("streamed, bag 300", 8192, 300, 5000, 16, torch.float32, False),
    ("streamed, bag 300", 8192, 300, 5000, 16, torch.bfloat16, False),
    ("streamed, wide rows", 3000, 5, 300, 1000, torch.float32, False),
    ("bag 1", 6656, 1, 4096, 16, torch.float32, False),
    ("bag 1", 6656, 1, 4096, 16, torch.bfloat16, False),
    ("bag 1, wide rows", 16, 1, 50, 1000, torch.float32, False),
    ("bag 1, misaligned", 100, 1, 200, 16, torch.float32, True),
    ("misaligned", 64, 26, 1000, 128, torch.float32, True),
    ("misaligned", 64, 26, 1000, 128, torch.bfloat16, True),
    ("misaligned, bag 300", 5, 300, 1000, 128, torch.float32, True),
    ("odd dim 130", 33, 26, 500, 130, torch.float32, False),
    ("odd dim 130", 33, 26, 500, 130, torch.bfloat16, False),
    ("odd dim 5", 7, 3, 50, 5, torch.float32, False),
    ("4-byte rows, bag 300", 40, 300, 100, 1, torch.float32, False),
    ("bf16 rows of 24 bytes", 33, 5, 64, 12, torch.bfloat16, False),
]


@pytest.mark.parametrize("label,N,bag,V,dim,dtype,misaligned",
                         BAG_PATH_CASES)
def test_embedding_bag_kernel_bit_equal_on_every_path(cuda, label, N, bag, V,
                                                      dim, dtype,
                                                      misaligned):
    """Each path bit-equal to ``embedding_bag_ordered`` and to its own
    second launch, within the reference's tolerance of the plain version,
    one launch a call."""
    ids, table = _bag_inputs(N, bag, V, dim, dtype, cuda, seed=bag)
    if misaligned:
        base = torch.empty(table.numel() + 1, dtype=dtype, device=cuda)
        table = base[1:].view(V, dim).copy_(table)
        assert table.is_contiguous() and table.data_ptr() % 16
    n = bk.embedding_bag_cuda.launches
    got = bk.embedding_bag_cuda(ids, table)
    assert bk.embedding_bag_cuda.launches == n + 1
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (N, dim)
    assert torch.equal(got, bk.embedding_bag_ordered(ids, table)), label
    if bag <= 26:
        torch.testing.assert_close(got.float(), bk.embedding_bag_ref(
            ids, table).float(), atol=BAG_TOL[dtype], rtol=0)
    assert torch.equal(bk.embedding_bag_cuda(ids, table), got), label
    assert bk.embedding_bag_cuda.launches == n + 2


def test_chip_smoke_baseline_launches_the_earlier_embedding_bag(cuda,
                                                                tmp_path):
    """``chip_smoke.py --baseline OLD/embedding_bag.cu``: inside
    ``earlier_kernels`` the wrapper launches the earlier build (here the
    current source with a comment appended), and the current one after."""
    import ctypes
    import sys
    from pathlib import Path

    from repro_torch.kernels import _build

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke

    old = tmp_path / "embedding_bag.cu"
    old.write_text((_build.CSRC / "embedding_bag.cu").read_text()
                   + "// earlier\n")
    libs = chip_smoke.build_earlier([str(old)])
    ids, table = _bag_inputs(256, 26, 1000, 128, torch.float32, cuda)
    want = bk.embedding_bag_cuda(ids, table)
    current = _build.load("embedding_bag")

    def addr(fn):
        return ctypes.cast(fn, ctypes.c_void_p).value

    with chip_smoke.earlier_kernels({"embedding_bag": bk}, libs):
        assert addr(bk._kernel_fns()[0]) == addr(
            libs["embedding_bag"].embedding_bag)
        got = bk.embedding_bag_cuda(ids, table)
    assert addr(bk._kernel_fns()[0]) == addr(current.embedding_bag)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_embedding_bag_kernel_rejects_what_it_does_not_take(cuda):
    ids, table = _bag_inputs(4, 2, 10, 8, torch.float32, cuda)
    with pytest.raises(ValueError, match="CUDA tensors"):
        bk.embedding_bag_cuda(ids.cpu(), table)
    with pytest.raises(ValueError, match="dtype"):
        bk.embedding_bag_cuda(ids, table.half())
    with pytest.raises(ValueError, match="ids dtype"):
        bk.embedding_bag_cuda(ids.to(torch.int16), table)
    with pytest.raises(ValueError, match=r"\(N, bag\)"):
        bk.embedding_bag_cuda(ids[:, 0], table)
    with pytest.raises(RuntimeError, match="no backward"):
        bk.embedding_bag_cuda(ids, table.clone().requires_grad_(True))


def test_sharded_table_on_the_card_matches_the_host_table(cuda):
    """Pulls (cold and through the hot cache), pushes with and without
    dedup and a re-pin: the card's table is bit-equal to the CPU one, and
    every pull that finds the cache launches the kernel once."""
    from repro_torch.ps import ShardedTable

    r = np.random.default_rng(0)
    dense = r.standard_normal((101, 8)).astype(np.float32)
    tables = [ShardedTable.from_dense(dense, 3, device=d, hot_capacity=16)
              for d in ("cpu", cuda)]
    try:
        n = bk.embedding_bag_cuda.launches
        for step in range(6):
            ids = r.integers(0, 40, (5, 7)).astype(np.int32)
            grads = r.standard_normal((5, 7, 8)).astype(np.float32)
            rows = [t.pull(ids) for t in tables]
            assert rows[1].device.type == "cuda"
            assert torch.equal(rows[0], rows[1].cpu())
            for t in tables:
                t.push(ids, torch.from_numpy(grads).to(t.device), lr=0.1,
                       dedup=bool(step % 2))
            if step == 1:
                for t in tables:
                    t.install_hot_rows(np.arange(12))
        assert tables[1].hot_pulls == 4
        assert bk.embedding_bag_cuda.launches == n + 4
        assert torch.equal(tables[0].to_dense(), tables[1].to_dense())
        assert torch.equal(tables[0].hot_rows, tables[1].hot_rows.cpu())
    finally:
        for t in tables:
            t.close()


@pytest.mark.parametrize("mode", ["sync", "async"])
def test_ctr_training_on_the_card_equals_the_plain_gather(cuda, mode):
    """A short CTR run on the card through the kernel and through the
    plain gather: the same losses bit for bit in sync mode (the push is
    deterministic), the kernel launched once per pull that found the
    cache; the tower and the cache on the card."""
    from repro_torch.ps import CTRConfig, make_table, train_ctr_ps

    cfg = CTRConfig(vocab=2000, emb_dim=8, slots=6, tower=(32,), batch=64,
                    lr=0.1)
    out = {}
    for impl in ("auto", "ref"):
        table = make_table(cfg, 3, device=cuda, impl=impl)
        n = bk.embedding_bag_cuda.launches
        try:
            out[impl] = train_ctr_ps(cfg, steps=25, mode=mode,
                                     repin_interval=10, table=table)
        finally:
            table.close()
        launched = bk.embedding_bag_cuda.launches - n
        assert launched == (out[impl]["hot_pulls"] if impl == "auto" else 0)
    s = out["auto"]
    assert s["repins"] == 2 and s["hot_pulls"] > 0
    assert s["devices"] == {"tower": ["cuda:0"], "hot_cache": "cuda:0"}
    if mode == "sync":
        assert s["losses"] == out["ref"]["losses"]
