#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its own line; any failure exits nonzero before the
result lines:

1. device  — the card's name, count, and ``nvidia-smi``'s name and power
             limit;
2. build   — builds the CUDA kernels of the serve and train paths
             (``src/repro_torch/kernels/csrc/*.cu``), one nvcc each, all
             started together;
3. kernels — each kernel against its plain PyTorch version on the card:
             paged decode at the test shapes and the llama3.2-1b and
             olmoe-1b-7b decode shapes, float32 (atol 2e-5) and bfloat16
             (atol 2e-2); MoE dispatch and combine at the reference test
             sweep, olmoe-1b-7b's decode and prefill shapes and with
             out-of-range indices, float32 (atol 1e-5) and bfloat16
             (atol 5e-2); the MoE autograd Functions' dx / dbuf / dw
             against autograd of the slot versions at olmoe's prefill
             shape (atol 1e-5, dw 1e-4); flash attention forward at the
             reference sweep and partial tiles (float32 atol 2e-5,
             bfloat16 2e-2) and its dq / dk / dv against autograd of the
             plain version (float32 atol 1e-4 rtol 1e-4, bfloat16 atol
             5e-2 rtol 1.6e-2); embedding bag at the reference sweep, the
             CTR pulls, duplicate and out-of-range ids (float32 atol 1e-5,
             bfloat16 5e-2, a bag of one bit-equal to a gather);
4. serve   — ``serve_continuous`` of llama3.2-1b at full width (16
             layers, d_model 2048, random weights from a seed, float32) on
             a mix of prompts of 64-512 tokens, counting kernel launches
             (paged decode 16 per decode step, flash forward 16 per
             prefill), plus a teacher-forced ``decode_step`` through the
             kernel and through the gather;
5. profile — host clock vs profiled device time of full-width llama
             decode steps (device idle share, launches per step);
6. moe     — the same mix served by olmoe-1b-7b at full width (16 layers,
             64 experts, top-8, float32), counting launches (MoE kernels
             16 per decode step and per prefill, paged decode 16 per
             decode step), a teacher-forced prefill and ``decode_step``
             through the kernels against the plain versions, and a
             profiled decode step split by kernel;
7. train   — ``train("llama3.2-1b", reduced=False)`` on the card, float32
             with AdamW state on the card: 3 steps of 8 x 2048 tokens in
             microbatches of 4, counting the flash launches of every layer
             per step (forward twice: forward and remat recompute), finite
             losses and grad norms, peak memory;
8. teacher — one ``loss_fn`` and its gradients through the kernels against
             the plain versions on the card: llama3.2-1b and olmoe-1b-7b at
             full width and 2 layers;
9. train profile — one profiled full-width llama train step: host clock,
             device busy split by kernel, idle share;
10. ctr    — ``train_sparse_ps(steps=200)`` at ``CTRConfig()``'s full
             size (200,000 x 16 table in 4 in-process shard servers, tower
             416 -> 512 -> 512 -> 256 -> 1, batch 256) on the card, in sync
             and then async mode: 3 re-pins, a hot-cache hit fraction, the
             tower and the cache on the card, one embedding_bag launch per
             pull that found the cache; sync again with the lookups forced
             to the plain gather (losses bit-equal: the push is
             deterministic); the same sync run on the CPU's plain path
             (losses within 1e-4); 1,000 sync steps, over which the loss
             falls (the 200-step runs are too short to learn); 60 steps
             over 4 shard processes (losses bit-equal to in-process); a
             profiled window of sync steps (device idle share);
11. timing — each kernel at its main path's shapes beside its bound, its
             plain version and, where one exists, a library call (CUDA
             events, median of repeats, L2 flushed or exceeded).

It then prints one ``{"kernels": [...]}`` JSON line and, last, the
``{"ok": true, "device": {...}}`` line.  Imports neither jax nor the JAX
package.
"""

from __future__ import annotations

import dataclasses
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory rate
F32_FLOPS = 67e12                # H100 SXM float32 outside the tensor cores
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
MOE_TOL = {"float32": 1e-5, "bfloat16": 5e-2}
BF16_TC_FLOPS = 989e12           # H100 SXM dense bfloat16 tensor cores
KERNELS = ("paged_decode", "moe", "flash_attention",   # csrc/<name>.cu
           "embedding_bag")
BAG_TOL = {"float32": 1e-5, "bfloat16": 5e-2}
FLASH_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
FLASH_BWD_TOL = {"float32": (1e-4, 1e-4), "bfloat16": (5e-2, 1.6e-2)}


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


# --------------------------------------------------------------------------
# phase 3 helpers: inputs for the paged-decode kernel
# --------------------------------------------------------------------------


def paged_inputs(torch, *, B, KV, G, hd, ps, P, q_pos, dtype, seed,
                 scratch_rows=()):
    """Random q and page pools, a permuted page table (so the kernel
    really goes through the indirection) and ``q_pos``; rows listed in
    ``scratch_rows`` are inactive slots parked on the scratch page."""
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    N = 1 + B * P
    q = torch.randn((B, KV, G, hd), generator=g, device="cuda").to(dtype)
    kp = torch.randn((N, ps, KV, hd), generator=g, device="cuda").to(dtype)
    vp = torch.randn((N, ps, KV, hd), generator=g, device="cuda").to(dtype)
    perm = torch.randperm(B * P, generator=g, device="cuda")
    table = (1 + perm).reshape(B, P).to(torch.int32)
    for r in scratch_rows:
        table[r] = 0
    pos = torch.tensor(q_pos, dtype=torch.int32, device="cuda")
    return q, kp, vp, table.contiguous(), pos


#: (label, B, KV, G, hd, ps, P, window, softcap, q_pos, scratch rows)
def kernel_cases():
    cases = []
    # the CPU test sweep's cases (tests/test_kernels.py), incl. an inactive
    # slot at q_pos=0 on the scratch page
    for B, KV, G, hd, ps, P, w, sc in [
            (2, 2, 2, 64, 4, 4, None, None), (2, 1, 4, 32, 8, 3, 5, 30.0),
            (1, 4, 1, 16, 4, 3, None, 50.0), (3, 2, 4, 32, 4, 5, 7, None)]:
        pos = [ps * P - 1, ps + 1, 0][:B]
        cases.append((f"test B{B} KV{KV} G{G} hd{hd} ps{ps}", B, KV, G, hd,
                      ps, P, w, sc, pos, (2,) if B == 3 else ()))
    llama_pos = [2047, 1500, 1023, 700, 333, 64, 15, 0]
    for w, sc in [(None, None), (256, None), (None, 50.0), (256, 50.0)]:
        cases.append((f"llama B8 KV8 G4 hd64 w{w} cap{sc}", 8, 8, 4, 64, 16,
                      128, w, sc, llama_pos, (7,)))
    cases.append(("G6 hd128 (internlm2)", 2, 8, 6, 128, 16, 8, None, None,
                  [127, 40], ()))
    cases.append(("G16 hd128 (chatglm3)", 2, 2, 16, 128, 16, 8, None, None,
                  [100, 17], ()))
    cases.append(("G2 hd256 w64 cap50 (gemma2)", 2, 4, 2, 256, 16, 8, 64,
                  50.0, [127, 70], ()))
    cases.append(("olmoe B4 KV16 G1 hd128", 4, 16, 1, 128, 16, 35, None,
                  None, [543, 300, 77, 0], (3,)))
    return cases


def phase_kernels(torch, pk):
    worst = {"float32": 0.0, "bfloat16": 0.0}
    for label, B, KV, G, hd, ps, P, w, sc, pos, scr in kernel_cases():
        for dname in ("float32", "bfloat16"):
            dtype = getattr(torch, dname)
            q, kp, vp, table, qp = paged_inputs(
                torch, B=B, KV=KV, G=G, hd=hd, ps=ps, P=P, q_pos=pos,
                dtype=dtype, seed=len(label), scratch_rows=scr)
            got = pk.paged_decode_cuda(q, kp, vp, table, qp, window=w,
                                       softcap=sc)
            want = pk.paged_decode_gather(q, kp, vp, table, qp, window=w,
                                          softcap=sc)
            torch.cuda.synchronize()
            check(bool(torch.isfinite(got.float()).all()),
                  f"{label} {dname}: non-finite output")
            err = (got.float() - want.float()).abs().max().item()
            worst[dname] = max(worst[dname], err)
            check(err <= TOL[dname],
                  f"{label} {dname}: max|kernel-gather| {err:.3e} > "
                  f"{TOL[dname]:.0e}")
        say("kernels", f"paged_decode ok: {label}")
    say("kernels", f"paged_decode max|err| float32 {worst['float32']:.3e} "
        f"(atol 2e-5), bfloat16 {worst['bfloat16']:.3e} (atol 2e-2)")
    return worst


def moe_inputs(torch, nn_moe, mk, *, G, S, D, E, K, cf, dtype, seed):
    """Tokens and a router at the init scale, routed by ``moe_route`` as
    ``moe_ffn`` routes them: (x, slot_src, slot_w) for dispatch and
    (eid, pos, w) for combine, with the capacity C."""
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    x = torch.randn((G, S, D), generator=g, device="cuda")
    router = torch.randn((D, E), generator=g, device="cuda") / D ** 0.5
    C = nn_moe.moe_capacity(S, E, K, cf)
    _, gate, eid, pos, keep = nn_moe.moe_route(router, x, top_k=K,
                                               capacity=C)
    nk = mk.slot_maps(eid, pos, keep, num_experts=E, capacity=C)
    src = mk.slot_sources(nk, top_k=K)
    sw = mk.slot_weights(nk, keep.to(torch.float32))
    w = (gate.reshape(G, S * K) * keep).reshape(G, S, K)
    safe = torch.where(keep, pos, 0).reshape(G, S, K)
    return x.to(dtype), src, sw, eid.reshape(G, S, K), safe, w, C


#: (label, G, S, D, E, K, cf): the reference test sweep
#: (tests/test_kernels.py) and olmoe-1b-7b's decode and prefill shapes
MOE_CASES = [
    ("test G2 S24 D16 E4 K2 cf1.25", 2, 24, 16, 4, 2, 1.25),
    ("test G1 S64 D32 E8 K2 cf1.0", 1, 64, 32, 8, 2, 1.0),
    ("test G2 S32 D16 E4 K1 cf0.25 (drops)", 2, 32, 16, 4, 1, 0.25),
    ("test G1 S8 D16 E4 K4 cf8 (top_k = E)", 1, 8, 16, 4, 4, 8.0),
    ("olmoe decode G4 S1 D2048 E64 K8 C8", 4, 1, 2048, 64, 8, 1.25),
    ("olmoe prefill G1 S512 D2048 E64 K8 C80", 1, 512, 2048, 64, 8, 1.25),
]


def phase_moe_kernels(torch, mk):
    from repro_torch.nn import moe as nn_moe

    worst = {k: {"float32": 0.0, "bfloat16": 0.0}
             for k in ("moe_dispatch", "moe_combine")}

    def held(label, dname, got, want):
        """``label`` starts with the kernel's name: dispatch or combine."""
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        kname = "moe_" + label.split()[0]
        worst[kname][dname] = max(worst[kname][dname], err)
        check(err <= MOE_TOL[dname], f"{label} {dname}: max|kernel-slot| "
              f"{err:.3e} > {MOE_TOL[dname]:.0e}")

    for label, G, S, D, E, K, cf in MOE_CASES:
        for dname in ("float32", "bfloat16"):
            x, src, sw, eid, pos, w, C = moe_inputs(
                torch, nn_moe, mk, G=G, S=S, D=D, E=E, K=K, cf=cf,
                dtype=getattr(torch, dname), seed=len(label))
            buf = mk.moe_dispatch_cuda(x, src, sw)
            check(buf.shape == (G, E, C, D), f"{label}: slab {buf.shape}")
            held(f"dispatch {label}", dname, buf,
                 mk.dispatch_slot(x, src, sw))
            check(bool(torch.isfinite(buf.float()).all()),
                  f"{label} {dname}: non-finite slab")
            held(f"combine {label}", dname, mk.moe_combine_cuda(buf, eid,
                                                                pos, w),
                 mk.combine_slot(buf, eid, pos, w))
            # the slab as the expert product leaves it: a (G, E, C, D)
            # view of (E, G, C, D) storage, read through its strides
            strided = buf.transpose(0, 1).contiguous().transpose(0, 1)
            held(f"combine {label} strided slab", dname,
                 mk.moe_combine_cuda(strided, eid, pos, w),
                 mk.combine_slot(buf, eid, pos, w))
        say("kernels", f"moe_dispatch + moe_combine ok: {label} (C {C})")

    # indices outside the arrays, negative and past the end: both kernels
    # clamp them into the arrays as the plain versions do.  Weights are
    # drawn as the model makes them: keep masks and gates in [0, 1], a
    # token's gates summing to 1 (bfloat16's tolerance is for that range)
    g = torch.Generator(device="cuda")
    g.manual_seed(7)
    G, S, D, E, C, K = 2, 7, 2048, 64, 8, 8
    for dname in ("float32", "bfloat16"):
        dt = getattr(torch, dname)
        x = torch.randn((G, S, D), generator=g, device="cuda").to(dt)
        src = torch.randint(-3, S + 4, (G, E, C), generator=g,
                            device="cuda", dtype=torch.int32)
        sw = torch.rand((G, E, C), generator=g, device="cuda")
        held("dispatch clamp", dname, mk.moe_dispatch_cuda(x, src, sw),
             mk.dispatch_slot(x, src, sw))
        buf = torch.randn((G, E, C, D), generator=g, device="cuda").to(dt)
        eid = torch.randint(-2, E + 3, (G, S, K), generator=g,
                            device="cuda", dtype=torch.int32)
        pos = torch.randint(-2, C + 5, (G, S, K), generator=g,
                            device="cuda", dtype=torch.int32)
        w = torch.rand((G, S, K), generator=g, device="cuda")
        w = w / w.sum(-1, keepdim=True)
        held("combine clamp", dname, mk.moe_combine_cuda(buf, eid, pos, w),
             mk.combine_slot(buf, eid, pos, w))
    say("kernels", "moe_dispatch + moe_combine ok: out-of-range src/eid/pos "
        "clamped")
    for kname, err in worst.items():
        say("kernels", f"{kname} max|err| float32 {err['float32']:.3e} "
            f"(atol 1e-5), bfloat16 {err['bfloat16']:.3e} (atol 5e-2)")
    return worst


def phase_moe_backward(torch, mk):
    """The MoE autograd Functions (``kernels.ops.moe_dispatch`` /
    ``moe_combine`` with ``impl="cuda"``) against autograd of the slot
    versions at olmoe-1b-7b's 512-token prefill shape, float32: dx through
    dispatch's backward (the combine kernel), dbuf through combine's
    backward (the dispatch kernel) at atol 1e-5, dw (a gather-dot over D =
    2048 in another order) at atol 1e-4.  dw of a dropped pair is 0 (the
    reference's backward masks it by keep)."""
    from repro_torch.kernels import ops
    from repro_torch.nn import moe as nn_moe

    G, S, D, E, K = 1, 512, 2048, 64, 8
    g = torch.Generator(device="cuda")
    g.manual_seed(21)
    x = torch.randn((G, S, D), generator=g, device="cuda")
    router = torch.randn((D, E), generator=g, device="cuda") / D ** 0.5
    C = nn_moe.moe_capacity(S, E, K, 1.25)
    _, gate, eid, pos, keep = nn_moe.moe_route(router, x, top_k=K,
                                               capacity=C)
    wtok = keep.to(torch.float32)
    w = (gate.reshape(G, S * K) * keep).reshape(G, S, K)
    safe = torch.where(keep, pos, 0).reshape(G, S, K)
    g_buf = torch.randn((G, E, C, D), generator=g, device="cuda")
    g_y = torch.randn((G, S, D), generator=g, device="cuda")

    def grads(impl):
        xi = x.clone().requires_grad_(True)
        buf = ops.moe_dispatch(xi, eid, pos, wtok, num_experts=E, capacity=C,
                               top_k=K, impl=impl)
        (dx,) = torch.autograd.grad(buf, (xi,), g_buf)
        b = buf.detach().clone().requires_grad_(True)
        wi = w.clone().requires_grad_(True)
        y = ops.moe_combine(b, eid.reshape(G, S, K), safe, wi, impl=impl)
        dbuf, dw = torch.autograd.grad(y, (b, wi), g_y)
        return dx, dbuf, torch.where(keep.reshape(G, S, K), dw, 0.0)

    n0 = (mk.moe_dispatch_cuda.launches, mk.moe_combine_cuda.launches)
    got = grads("cuda")
    check((mk.moe_dispatch_cuda.launches - n0[0],
           mk.moe_combine_cuda.launches - n0[1]) == (2, 2),
          "the MoE Functions' backward did not launch the other kernel")
    want = grads("slot")
    torch.cuda.synchronize()
    errs = {}
    for name, a, b, atol in zip(("dx", "dbuf", "dw"), got, want,
                                (1e-5, 1e-5, 1e-4)):
        check(bool(torch.isfinite(a).all()), f"MoE backward {name}: "
              "non-finite")
        errs[name] = (a - b).abs().max().item()
        check(errs[name] <= atol, f"MoE backward {name}: max|Function - "
              f"slot autograd| {errs[name]:.3e} > {atol:.0e}")
    say("kernels", f"MoE backward at olmoe prefill G1 S512 E64 K8 C{C}: "
        f"max|err| dx {errs['dx']:.3e}, dbuf {errs['dbuf']:.3e} (atol 1e-5; "
        f"dispatch's backward is the combine kernel and back), dw "
        f"{errs['dw']:.3e} (atol 1e-4)")
    return errs


#: (label, B, H, Sq, Sk, hd, causal, window, softcap): the reference sweep
#: (tests/test_kernels.py: shapes, windows 32/100/128, softcap 50, non
#: causal, cross lengths), partial tiles, windows that leave rows with no
#: key, and the shapes train() feeds the kernels (llama3.2-1b's microbatch
#: of 4, olmoe-1b-7b's heads)
FLASH_CASES = [
    ("test B1 H1 S128 hd64", 1, 1, 128, 128, 64, True, None, None),
    ("test B2 H2 S256 hd64", 2, 2, 256, 256, 64, True, None, None),
    ("test B1 H2 S384 hd128", 1, 2, 384, 384, 128, True, None, None),
    ("test B1 H1 S128 hd256", 1, 1, 128, 128, 256, True, None, None),
    ("test window 32", 1, 2, 256, 256, 64, True, 32, None),
    ("test window 100", 1, 2, 256, 256, 64, True, 100, None),
    ("test window 128", 1, 2, 256, 256, 64, True, 128, None),
    ("test softcap 50", 1, 1, 128, 128, 64, True, None, 50.0),
    ("test non-causal Sk256", 2, 1, 128, 256, 64, False, None, None),
    ("test cross Sk384", 1, 2, 128, 384, 64, False, None, None),
    ("causal S200 (not a multiple of 128)", 1, 4, 200, 200, 64, True, None,
     None),
    ("causal S300 hd128 window 40 softcap 30", 1, 2, 300, 300, 128, True,
     40, 30.0),
    ("non-causal Sq256 Sk128 window 20 (rows 147.. see no key)", 1, 2, 256,
     128, 64, False, 20, None),
    ("causal Sq200 Sk64 hd128 window 16 softcap 30 (rows 79.. see no key)",
     1, 2, 200, 64, 128, True, 16, 30.0),
    ("llama train B4 H32 S2048 hd64", 4, 32, 2048, 2048, 64, True, None,
     None),
    ("olmoe train B1 H4 S512 hd128", 1, 4, 512, 512, 128, True, None, None),
]


def phase_flash_kernels(torch, fk):
    """The flash forward against ``flash_attention_ref`` and the backward
    (dK/dV pass, then dQ pass) against autograd of it, on the same inputs.
    Returns each entry point's worst error per dtype."""
    worst = {n: {"float32": 0.0, "bfloat16": 0.0}
             for n in ("flash_fwd", "flash_bwd_dkdv", "flash_bwd_dq")}
    for label, B, H, Sq, Sk, hd, causal, window, cap in FLASH_CASES:
        kw = {"causal": causal, "window": window, "softcap": cap}
        for dname in ("float32", "bfloat16"):
            dt = getattr(torch, dname)
            g = torch.Generator(device="cuda")
            g.manual_seed(len(label))
            q, k, v = (torch.randn(s, generator=g, device="cuda").to(dt)
                       for s in ((B, H, Sq, hd), (B, H, Sk, hd),
                                 (B, H, Sk, hd)))
            do = torch.randn((B, H, Sq, hd), generator=g,
                             device="cuda").to(dt)
            o, lse = fk.flash_fwd_cuda(q, k, v, **kw)
            want = fk.flash_attention_ref(q, k, v, **kw)
            torch.cuda.synchronize()
            check(bool(torch.isfinite(o.float()).all()),
                  f"flash {label} {dname}: non-finite output")
            err = (o.float() - want.float()).abs().max().item()
            worst["flash_fwd"][dname] = max(worst["flash_fwd"][dname], err)
            check(err <= FLASH_TOL[dname], f"flash {label} {dname}: "
                  f"max|kernel-plain| {err:.3e} > {FLASH_TOL[dname]:.0e}")
            dk, dv, delta = fk.flash_bwd_dkdv_cuda(q, k, v, o, lse, do, **kw)
            dq = fk.flash_bwd_dq_cuda(q, k, v, do, lse, delta, **kw)
            qkv = [t.clone().requires_grad_(True) for t in (q, k, v)]
            ref = torch.autograd.grad(fk.flash_attention_ref(*qkv, **kw),
                                      qkv, do)
            torch.cuda.synchronize()
            atol, rtol = FLASH_BWD_TOL[dname]
            for name, a, b in (("dq", dq, ref[0]), ("dk", dk, ref[1]),
                               ("dv", dv, ref[2])):
                a, b = a.float(), b.float()
                check(bool(torch.isfinite(a).all()),
                      f"flash {label} {dname}: non-finite {name}")
                bad = (a - b).abs() - (atol + rtol * b.abs())
                check(bool((bad <= 0).all()), f"flash {label} {dname}: {name}"
                      f" off by {bad.max().item() + atol:.3e} beyond atol "
                      f"{atol:.0e} rtol {rtol:.1e}")
                entry = "flash_bwd_dq" if name == "dq" else "flash_bwd_dkdv"
                worst[entry][dname] = max(worst[entry][dname],
                                          (a - b).abs().max().item())
        say("kernels", f"flash forward + backward ok: {label}")
    for name, err in worst.items():
        say("kernels", f"{name} max|err| float32 {err['float32']:.3e}, "
            f"bfloat16 {err['bfloat16']:.3e}")
    return worst


#: (label, N, bag, V, dim): the reference sweep (tests/test_kernels.py),
#: the CTR path's pulls (the hot-cache lookup of a whole batch, and the
#: batch's 26 slots pooled from the full table) and ragged widths
BAG_CASES = [
    ("test N8 bag4 V100 dim128", 8, 4, 100, 128),
    ("test N16 bag1 V50 dim128", 16, 1, 50, 128),
    ("test N4 bag16 V1000 dim256", 4, 16, 1000, 256),
    ("ctr hot-cache lookup N6656 bag1 V4096 dim16", 6656, 1, 4096, 16),
    ("ctr pooled N256 bag26 V200000 dim16", 256, 26, 200_000, 16),
    ("ragged N7 bag3 V50 dim5", 7, 3, 50, 5),
    ("ragged N33 bag5 V64 dim12", 33, 5, 64, 12),
]


def phase_bag_kernels(torch, bk):
    """embedding_bag against its plain version; a bag of one bit-equal to
    a gather; duplicate ids; out-of-range ids (negative, past the table,
    past int32 in int64) clamped."""
    worst = {"float32": 0.0, "bfloat16": 0.0}

    def held(label, dname, ids, table):
        got = bk.embedding_bag_cuda(ids, table)
        want = bk.embedding_bag_ref(ids, table)
        torch.cuda.synchronize()
        check(got.dtype == table.dtype and bool(
            torch.isfinite(got.float()).all()), f"{label} {dname}: output")
        err = (got.float() - want.float()).abs().max().item()
        worst[dname] = max(worst[dname], err)
        check(err <= BAG_TOL[dname], f"{label} {dname}: max|kernel-plain| "
              f"{err:.3e} > {BAG_TOL[dname]:.0e}")
        return got

    g = torch.Generator(device="cuda")
    for label, N, bag, V, dim in BAG_CASES:
        g.manual_seed(len(label))
        for dname in ("float32", "bfloat16"):
            dt = getattr(torch, dname)
            ids = torch.randint(0, V, (N, bag), generator=g, device="cuda",
                                dtype=torch.int32)
            table = torch.randn((V, dim), generator=g, device="cuda").to(dt)
            got = held(label, dname, ids, table)
            if bag == 1:
                check(torch.equal(got, table[ids[:, 0].long()]),
                      f"{label} {dname}: a bag of one is not bit-equal to "
                      "a gather")
        say("kernels", f"embedding_bag ok: {label}")
    for dname in ("float32", "bfloat16"):
        dt = getattr(torch, dname)
        table = torch.randn((40, 16), generator=g, device="cuda").to(dt)
        dup = torch.zeros((4, 8), dtype=torch.int32, device="cuda")
        held("duplicates", dname, dup, table)
        ids = torch.randint(-9, 50, (64, 6), generator=g, device="cuda")
        ids[3, 2] = 2 ** 40
        held("out of range (int64)", dname, ids, table)
        held("out of range (int32)", dname, ids.clamp(-9, 50).int(), table)
    say("kernels", "embedding_bag ok: duplicates; out-of-range ids clamped")
    say("kernels", f"embedding_bag max|err| float32 {worst['float32']:.3e} "
        f"(atol 1e-5), bfloat16 {worst['bfloat16']:.3e} (atol 5e-2)")
    return worst


# --------------------------------------------------------------------------
# phases 4 and 6: the main paths
# --------------------------------------------------------------------------

REQUESTS = [(64, 32), (512, 32), (128, 32), (300, 32), (96, 32), (448, 32),
            (200, 32), (256, 32)]


def counted_serve(torch, counters, arch, params):
    """One ``serve_continuous`` of REQUESTS at full width with every
    launch count set to 0 just before it and read just after; checks the
    outcomes and prints the rates."""
    from repro_torch.launch.serve import serve_continuous

    # the same mix once first: CUDA start-up and the first use of every
    # matmul shape stay out of the measured run
    t0 = time.perf_counter()
    serve_continuous(arch, reduced=False, device="cuda", requests=REQUESTS,
                     slots=4, params=params)
    say("serve", f"{arch}: warm-up run of the same mix "
        f"{time.perf_counter() - t0:.2f} s")
    for fn in counters.values():
        fn.launches = 0
    out = serve_continuous(arch, reduced=False, device="cuda",
                           requests=REQUESTS, slots=4, params=params)
    launches = {name: fn.launches for name, fn in counters.items()}
    check(out["outcomes"] == ["completed"] * len(REQUESTS),
          f"{arch} outcomes {out['outcomes']}")
    check(out["generated"] == [g for _, g in REQUESTS],
          f"{arch} generated {out['generated']}")
    check(out["tokens_in_vocab"], f"{arch}: tokens outside the vocabulary")
    check(out["pool_conserved"], f"{arch}: page pool not conserved")
    check(out["decode_steps"] > 0, f"{arch}: no decode step")
    ttft = [t for t in out["ttft_s"] if t is not None]
    toks = sum(out["generated"])
    say("serve", f"{arch}: {len(REQUESTS)} requests completed, {toks} "
        f"tokens, {out['decode_steps']} decode steps, {out['prefills']} "
        f"prefills; launches {launches}")
    say("serve", f"{arch}: decode tok/s {toks / out['decode_s']:.1f} "
        f"(inside decode chunks, 4 slots), {out['decode_tok_per_s']:.1f} "
        f"(whole run incl. prefills); TTFT p50 "
        f"{statistics.median(ttft) * 1e3:.1f} ms, max "
        f"{max(ttft) * 1e3:.1f} ms (all arrive at t=0); wall "
        f"{out['wall_s']:.2f} s")
    return out, launches


def teacher_forced_inputs(torch, dec, cfg_p, plens, seed=1):
    """A paged cache (4 slots) and right-padded prompts of ``plens``."""
    B = len(plens)
    cache = dec.init_cache(cfg_p, B, 576, dtype=torch.float32,
                           device="cuda")
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    prompts = torch.randint(0, cfg_p.vocab, (B, max(plens)), generator=g,
                            device="cuda", dtype=torch.int32)
    return cache, prompts, torch.tensor(plens, device="cuda")


def first_tokens(torch, lg, plens, vocab):
    return torch.stack([lg[b, n - 1, :vocab].argmax()
                        for b, n in enumerate(plens)]).to(torch.int32)[:, None]


def check_prefill_flash(launches, layers, prefills, arch):
    """Every causal prefill runs the flash forward once per layer; serving
    runs no backward."""
    check(launches["flash_fwd"] == layers * prefills,
          f"{arch}: flash_fwd launches {launches['flash_fwd']} != {layers} x "
          f"{prefills} prefills")
    check(launches["flash_bwd_dkdv"] == launches["flash_bwd_dq"] == 0,
          f"{arch}: serving launched a flash backward")
    say("serve", f"{arch}: flash_fwd launches = {layers} x {prefills} "
        f"prefills = {launches['flash_fwd']}")


def phase_serve(torch, counters):
    from repro_torch.configs import get_config
    from repro_torch.models import decoder as dec

    pk_fn = counters["paged_decode"]
    cfg = get_config("llama3.2-1b", reduced=False)
    t0 = time.perf_counter()
    params = dec.init_model(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    say("serve", f"llama3.2-1b full width: {cfg.num_layers} layers, d_model "
        f"{cfg.d_model}, vocab {cfg.vocab}, float32 weights from seed 0 in "
        f"{time.perf_counter() - t0:.1f} s")
    out, launches = counted_serve(torch, counters, "llama3.2-1b", params)
    steps, layers = out["decode_steps"], cfg.num_layers
    check(launches["paged_decode"] == layers * steps,
          f"paged_decode launches {launches['paged_decode']} != {layers} x "
          f"{steps} steps")
    check_prefill_flash(launches, layers, out["prefills"], "llama3.2-1b")

    # teacher-forced: one decode step on one cache, kernel vs gather
    plens = [512, 300, 150, 77]
    cfg_p = dataclasses.replace(cfg, kv_impl="paged")
    cache, prompts, lens = teacher_forced_inputs(torch, dec, cfg_p, plens)
    lg, cache = dec.prefill(params, cfg_p, prompts, cache, lengths=lens,
                            compute_dtype=torch.float32)
    tok = first_tokens(torch, lg, plens, cfg.vocab)
    n0 = pk_fn.launches
    la, _ = dec.decode_step(params, cfg_p, tok, cache,
                            compute_dtype=torch.float32, impl="auto")
    lb, _ = dec.decode_step(params, cfg_p, tok, cache,
                            compute_dtype=torch.float32, impl="gather")
    torch.cuda.synchronize()
    check(pk_fn.launches - n0 == layers,
          "impl='auto' did not launch the kernel in every layer")
    check(bool(torch.isfinite(la).all()), "non-finite decode logits")
    err = (la - lb).abs().max().item()
    check(err <= 1e-3, f"decode_step logits kernel vs gather {err:.3e} > 1e-3")
    say("serve", f"teacher-forced decode_step, kernel vs gather: max|dlogit| "
        f"{err:.3e} (atol 1e-3)")
    return launches, (params, cfg_p, cache, tok)


def phase_moe(torch, counters):
    """olmoe-1b-7b at full width: the counted serve, then a teacher-forced
    prefill and decode step through the kernels and the plain versions."""
    from repro_torch.configs import get_config
    from repro_torch.models import decoder as dec
    from repro_torch.tree import tree_leaves

    cfg = get_config("olmoe-1b-7b", reduced=False)
    t0 = time.perf_counter()
    params = dec.init_model(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    n_par = sum(t.numel() for t in tree_leaves(params))
    say("moe", f"olmoe-1b-7b full width: {cfg.num_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.moe_experts} experts top-{cfg.moe_top_k}, "
        f"expert d_ff {cfg.moe_d_ff}, vocab {cfg.vocab}; {n_par} float32 "
        f"parameters from seed 0 in {time.perf_counter() - t0:.1f} s; "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated")
    out, launches = counted_serve(torch, counters, "olmoe-1b-7b", params)
    steps, pre, layers = out["decode_steps"], out["prefills"], cfg.num_layers
    for name in ("moe_dispatch", "moe_combine"):
        check(launches[name] == layers * (steps + pre),
              f"{name} launches {launches[name]} != {layers} x ({steps} "
              f"decode steps + {pre} prefills)")
    check(launches["paged_decode"] == layers * steps,
          f"paged_decode launches {launches['paged_decode']} != {layers} x "
          f"{steps} steps")
    check_prefill_flash(launches, layers, pre, "olmoe-1b-7b")
    say("moe", f"launches: moe_dispatch = moe_combine = {layers} x ({steps} "
        f"+ {pre}) = {launches['moe_dispatch']}, paged_decode = {layers} x "
        f"{steps} = {launches['paged_decode']}")

    # teacher-forced: batched prefill (one routing group of up to 512
    # tokens per sequence, drops included) and one decode step, through
    # the kernels and through moe_impl="slot", attn_impl="ref" (the plain
    # flash attention) and the gather
    plens = [512, 300, 150, 77]
    cfg_p = dataclasses.replace(cfg, kv_impl="paged")
    cfg_s = dataclasses.replace(cfg_p, moe_impl="slot", attn_impl="ref")
    cache, prompts, lens = teacher_forced_inputs(torch, dec, cfg_p, plens)
    cache_s, _, _ = teacher_forced_inputs(torch, dec, cfg_p, plens)
    d0 = counters["moe_dispatch"].launches
    la, cache = dec.prefill(params, cfg_p, prompts, cache, lengths=lens,
                            compute_dtype=torch.float32)
    lb, cache_s = dec.prefill(params, cfg_s, prompts, cache_s, lengths=lens,
                              compute_dtype=torch.float32)
    torch.cuda.synchronize()
    check(counters["moe_dispatch"].launches - d0 == layers,
          "prefill did not launch the MoE kernels in every layer")
    errs = [max((la[b, :n] - lb[b, :n]).abs().max().item()
                for b, n in enumerate(plens))]
    tok = first_tokens(torch, la, plens, cfg.vocab)
    n0 = {k: fn.launches for k, fn in counters.items()}
    da, _ = dec.decode_step(params, cfg_p, tok, cache,
                            compute_dtype=torch.float32, impl="auto")
    db, _ = dec.decode_step(params, cfg_s, tok, cache,
                            compute_dtype=torch.float32, impl="gather")
    torch.cuda.synchronize()
    check(all(counters[k].launches - n0[k] == layers
              for k in ("paged_decode", "moe_dispatch", "moe_combine")),
          "decode_step did not launch every decode kernel in every layer")
    check(bool(torch.isfinite(da).all()), "non-finite olmoe decode logits")
    errs.append((da - db).abs().max().item())
    check(max(errs) <= 1e-3, f"olmoe teacher-forced logits, kernels vs plain "
          f"versions: prefill {errs[0]:.3e}, decode {errs[1]:.3e} > 1e-3")
    say("moe", f"teacher-forced prefill (prompts {plens}) and decode_step, "
        f"kernels vs plain versions: max|dlogit| prefill {errs[0]:.3e}, "
        f"decode {errs[1]:.3e} (atol 1e-3)")
    return launches, (params, cfg_p, cache, tok)


# --------------------------------------------------------------------------
# phase 5: where a decode step's time goes
# --------------------------------------------------------------------------

#: kernel-name fragments of the profile's device-time split, checked in
#: this order ("rest" takes what matches none)
PROFILE_SPLIT = (("embedding_bag", ("embedding_bag",)),
                 ("paged_decode", ("paged_decode",)),
                 ("moe_dispatch", ("dispatch_kernel",)),
                 ("moe_combine", ("combine_kernel",)),
                 ("flash_fwd", ("fwd_kernel",)),
                 ("flash_bwd", ("dkdv_kernel", "delta_kernel", "dq_kernel")),
                 ("matmul", ("gemm", "gemv")),
                 ("copies", ("copy",)))


def device_split(torch, prof, steps: int, label: str):
    """(device busy ms, {kernel group: ms}, kernel launches) per step from
    a ``torch.profiler`` run of ``steps`` steps."""
    from torch.autograd import DeviceType

    split = {name: 0.0 for name, _ in PROFILE_SPLIT}
    split["rest"] = 0.0
    dev_us, launches = 0.0, 0
    for e in prof.key_averages():
        if e.key in ("cudaLaunchKernel", "cuLaunchKernel",
                     "cuLaunchKernelEx", "cudaLaunchKernelExC"):
            launches += e.count
        if e.device_type != DeviceType.CUDA:
            continue
        t = e.self_device_time_total
        dev_us += t
        key = e.key.lower()
        name = next((n for n, frags in PROFILE_SPLIT
                     if any(f in key for f in frags)), "rest")
        split[name] += t
    check(dev_us > 0, f"{label}: the profiler saw no device time")
    return (dev_us / 1e3 / steps,
            {n: t / 1e3 / steps for n, t in split.items()}, launches / steps)


def phase_profile(torch, state, label: str, steps: int = 8):
    """Host clock of ``steps`` decode steps at full width (4 slots, KV
    lengths 77-512) beside the device time the profiler sees in them,
    split by kernel."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import decoder as dec

    params, cfg_p, cache, tok = state

    def run():
        dec.decode_loop(params, cfg_p, tok, cache, 0, steps,
                        compute_dtype=torch.float32)
        torch.cuda.synchronize()

    run()
    t0 = time.perf_counter()
    run()
    wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
    dev_ms, split, launches = device_split(torch, prof, steps, label)
    idle = 1.0 - dev_ms / wall_ms
    parts = ", ".join(f"{n} {t:.3f}" for n, t in split.items()
                      if t or n in ("matmul", "paged_decode", "rest"))
    say("profile", f"{label} decode step at full width, 4 slots: host clock "
        f"{wall_ms:.2f} ms/step; device busy {dev_ms:.3f} ms/step ({parts}); "
        f"device idle share {idle:.3f}; {launches:.0f} kernel "
        f"launches/step")


# --------------------------------------------------------------------------
# phases 7-9: training
# --------------------------------------------------------------------------

#: llama3.2-1b's training run: steps, batch, sequence, microbatch
TRAIN = (3, 8, 2048, 4)


def _batch_on_card(torch, ds, step):
    return {k: torch.from_numpy(v).to("cuda")
            for k, v in ds.batch(step).items()}


def phase_train(torch, counters):
    """``train("llama3.2-1b", reduced=False)`` on the card: 1.24 B float32
    parameters with their gradients and AdamW moments on the card, 3 steps
    of 8 x 2048 tokens in microbatches of 4.  Each layer of each
    microbatch launches the flash forward twice (the forward, and its
    recompute under per-layer remat in the backward pass) and each
    backward pass once."""
    from repro_torch.configs import get_config
    from repro_torch.launch.train import train

    steps, batch, seq, micro = TRAIN
    layers = get_config("llama3.2-1b", reduced=False).num_layers
    n_micro = batch // micro
    for fn in counters.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = train("llama3.2-1b", reduced=False, device="cuda", steps=steps,
                batch=batch, seq=seq, microbatch=micro, log_every=1)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    peak = torch.cuda.max_memory_allocated() / 1e9
    per_step = {"flash_fwd": 2 * layers * n_micro,
                "flash_bwd_dkdv": layers * n_micro,
                "flash_bwd_dq": layers * n_micro}
    for name, n in per_step.items():
        check(launches[name] == steps * n, f"train: {name} launches "
              f"{launches[name]} != {steps} steps x {n}")
    check(all(launches[k] == 0 for k in counters if k not in per_step),
          f"train: unexpected launches {launches}")
    check(all(math.isfinite(x) for x in out["losses"] + out["grad_norms"]),
          f"train: non-finite loss or grad norm {out}")
    check(out["devices"] == ["cuda:0"],
          f"train: parameters or optimizer state on {out['devices']}")
    say("train", f"llama3.2-1b full width: {out['params']} float32 "
        f"parameters, {steps} steps of {batch} x {seq} tokens in "
        f"microbatches of {micro}; losses "
        f"{[round(x, 4) for x in out['losses']]}, grad norms "
        f"{[round(x, 4) for x in out['grad_norms']]}; state on "
        f"{out['devices']}")
    say("train", f"launches per step: flash_fwd {launches['flash_fwd'] // steps}"
        f" = 2 x {layers} layers x {n_micro} microbatches, flash_bwd_dkdv "
        f"{launches['flash_bwd_dkdv'] // steps}, flash_bwd_dq "
        f"{launches['flash_bwd_dq'] // steps}; wall {wall:.1f} s incl. "
        f"init, {out['seconds'] / steps:.2f} s/step; peak memory "
        f"{peak:.2f} GB")
    return launches, out, peak


def phase_teacher(torch, counters):
    """One ``loss_fn`` and its gradients through the kernels (flash forward
    and backward; for OLMoE also the MoE Functions) against the plain
    versions (``attn_impl="ref"``, ``moe_impl="slot"``) on the card, at full
    width and 2 layers, float32: llama3.2-1b on 2 x 2048 tokens and
    olmoe-1b-7b on 2 x 512.  Tolerance: the loss to 1e-5 relative, each
    gradient leaf to 1e-3 of its largest entry (attention summed in
    another order through two layers; routing is computed by the same
    code on both sides).  OLMoE trains only at 2 layers on one card: its
    6.9 B float32 parameters with gradients and two AdamW moments need
    about 110 GB (16 bytes a parameter), more than the card's 80 GB."""
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticTokenDataset
    from repro_torch.models import decoder as dec
    from repro_torch.tree import tree_leaves, tree_unflatten

    by_arch = {}
    for arch, B, S in (("llama3.2-1b", 2, 2048), ("olmoe-1b-7b", 2, 512)):
        cfg = dataclasses.replace(get_config(arch, reduced=False), repeats=2)
        params = dec.init_model(cfg, seed=0, device="cuda")
        batch = _batch_on_card(torch, SyntheticTokenDataset(cfg.vocab, B, S),
                               0)

        def value_and_grads(cfg_x):
            leaves = [t.detach().requires_grad_(True)
                      for t in tree_leaves(params)]
            loss = dec.loss_fn(tree_unflatten(params, leaves), cfg_x, batch,
                               compute_dtype=torch.float32)
            return loss.item(), torch.autograd.grad(loss, leaves)

        n0 = {k: fn.launches for k, fn in counters.items()}
        loss_k, g_k = value_and_grads(cfg)
        n1 = {k: fn.launches for k, fn in counters.items()}
        loss_r, g_r = value_and_grads(
            dataclasses.replace(cfg, attn_impl="ref", moe_impl="slot"))
        torch.cuda.synchronize()
        launched = {k: n1[k] - n0[k] for k in counters}
        check(all(fn.launches == n1[k] for k, fn in counters.items()),
              f"{arch}: the plain run launched a kernel")
        want = {"flash_fwd": 2 * cfg.num_layers,
                "flash_bwd_dkdv": cfg.num_layers,
                "flash_bwd_dq": cfg.num_layers}
        if cfg.has_moe:
            want.update(moe_dispatch=3 * cfg.num_layers,
                        moe_combine=3 * cfg.num_layers)
        check(all(launched[k] == want.get(k, 0) for k in counters),
              f"{arch}: kernel launches {launched}, expected {want}")
        check(math.isfinite(loss_k) and all(bool(torch.isfinite(g).all())
                                            for g in g_k),
              f"{arch}: non-finite loss or gradient")
        dloss = abs(loss_k - loss_r)
        rel = max(((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()
                  for a, b in zip(g_k, g_r))
        check(dloss <= 1e-5 * abs(loss_r), f"{arch}: loss through the kernels"
              f" {loss_k} vs plain {loss_r}")
        check(rel <= 1e-3, f"{arch}: a gradient leaf is off by {rel:.3e} of "
              "its largest entry (> 1e-3)")
        say("teacher", f"{arch} full width, 2 layers, {B} x {S} tokens: loss "
            f"{loss_k:.6f} (kernels) vs {loss_r:.6f} (plain), |dloss| "
            f"{dloss:.3e}; worst gradient leaf max|d| / max|g| {rel:.3e} "
            f"(tol 1e-3); kernel launches {launched}")
        by_arch[arch] = {"launches": launched, "dloss": dloss,
                         "grad_rel": rel}
        del params, g_k, g_r
        torch.cuda.empty_cache()
    return by_arch


def phase_train_profile(torch):
    """One full-width llama3.2-1b train step (the training run's shape,
    through ``make_train_step`` as ``train()`` builds it) after two
    unprofiled ones: host clock beside the device time split by kernel,
    and every tensor of the step's state and metrics on the card."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticTokenDataset
    from repro_torch.launch.steps import init_train_state, make_train_step
    from repro_torch.tree import tree_leaves

    _, batch, seq, micro = TRAIN
    cfg = get_config("llama3.2-1b", reduced=False)
    params, opt = init_train_state(cfg, seed=0, device="cuda")
    step = make_train_step(cfg, compute_dtype=torch.float32, microbatch=micro)
    ds = SyntheticTokenDataset(cfg.vocab, batch, seq)
    state = {"params": params, "opt": opt}

    def run(i):
        b = _batch_on_card(torch, ds, i)
        state["params"], state["opt"], m = step(state["params"],
                                                state["opt"], b)
        torch.cuda.synchronize()
        return m

    run(0)
    t0 = time.perf_counter()
    run(1)
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        m = run(2)
    tensors = (tree_leaves(state["params"]) + tree_leaves(state["opt"])
               + list(m.values()))
    check(all(t.is_cuda for t in tensors), "train step: a tensor of the "
          "state or metrics lies on the CPU")
    dev_ms, split, launches = device_split(torch, prof, 1, "train step")
    idle = 1.0 - dev_ms / wall_ms
    parts = ", ".join(f"{n} {t:.1f}" for n, t in split.items()
                      if t or n in ("matmul", "rest"))
    say("profile", f"llama3.2-1b train step at full width, {batch} x {seq} "
        f"tokens in microbatches of {micro}, float32: host clock "
        f"{wall_ms:.1f} ms; device busy {dev_ms:.1f} ms ({parts}); device "
        f"idle share {idle:.3f}; {launches:.0f} kernel launches; all "
        f"{len(tensors)} state and metric tensors on the card")
    return {"host_ms": wall_ms, "device_ms": dev_ms, "split_ms": split,
            "idle": idle, "launches": launches}


# --------------------------------------------------------------------------
# phase 10: CTR training over the parameter server
# --------------------------------------------------------------------------

#: the CTR runs: steps of the main-path runs (re-pins at 50, 100, 150),
#: of the learning run, and of the multiproc run (re-pins at 20, 40)
CTR_STEPS, CTR_LEARN_STEPS, CTR_MP_STEPS = 200, 1000, 60


def ctr_line(label, out, launches):
    say("ctr", f"{label}: {out['steps']} steps, {out['steps_per_sec']:.1f} "
        f"steps/s; pull {out['pull_seconds'] / out['steps'] * 1e3:.3f} ms, "
        f"push {out['push_seconds'] / out['steps'] * 1e3:.3f} ms per step; "
        f"loss {out['first_loss']:.4f} -> {out['last_loss']:.4f} "
        f"(loss_decreased {out['loss_decreased']}); {out['repins']} re-pins, "
        f"hot-pull fraction {out['hot_pull_fraction']:.4f}, "
        f"{out['hot_pulls']} pulls found the cache, embedding_bag "
        f"launches {launches}")


def counted_ctr(torch, bk, label, run):
    """``run()`` with the embedding_bag count set to 0 just before it and
    read just after; checks the summary and that the kernel launched once
    for every pull that found the cache."""
    bk.embedding_bag_cuda.launches = 0
    out = run()
    launches = bk.embedding_bag_cuda.launches
    ctr_line(label, out, launches)
    check(all(math.isfinite(x) for x in out["losses"]),
          f"{label}: non-finite loss")
    check(out["hot_pulls"] > 0 and launches == out["hot_pulls"],
          f"{label}: {launches} embedding_bag launches for "
          f"{out['hot_pulls']} pulls that found the cache")
    check(out["hot_pull_fraction"] > 0, f"{label}: no pull hit the cache")
    return out, launches


def phase_ctr(torch, bk):
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch.train import train_sparse_ps
    from repro_torch.ps.workload import CTRConfig, make_table, train_ctr_ps

    cfg = CTRConfig()
    say("ctr", f"CTRConfig(): vocab {cfg.vocab}, emb_dim {cfg.emb_dim}, "
        f"{cfg.slots} slots, tower {cfg.tower}, batch {cfg.batch}; 4 "
        "in-process shard servers, hot cache of 4,096 rows on the card")
    runs, launches = {}, {}
    for mode in ("sync", "async"):
        runs[mode], launches[mode] = counted_ctr(
            torch, bk, f"{mode} (train_sparse_ps, kernel)",
            lambda: train_sparse_ps(steps=CTR_STEPS, num_shards=4,
                                    sync=mode == "sync", log_every=0,
                                    device="cuda"))
        out = runs[mode]
        check(out["repins"] == 3, f"{mode}: {out['repins']} re-pins, not 3")
        check(out["devices"] == {"tower": ["cuda:0"],
                                 "hot_cache": "cuda:0"},
              f"{mode}: devices {out['devices']}")
    check(runs["sync"]["hot_pulls"] == CTR_STEPS - 51,
          f"sync: {runs['sync']['hot_pulls']} pulls found the cache, not "
          f"{CTR_STEPS - 51} (every pull after the first re-pin)")

    # the same sync run with the lookups forced to the plain gather
    table = make_table(cfg, 4, device="cuda", impl="ref")
    bk.embedding_bag_cuda.launches = 0
    try:
        plain = train_ctr_ps(cfg, steps=CTR_STEPS, mode="sync", table=table)
    finally:
        table.close()
    check(bk.embedding_bag_cuda.launches == 0, "the plain run launched the "
          "kernel")
    check(plain["losses"] == runs["sync"]["losses"],
          "sync losses through the kernel differ from the plain gather's")
    say("ctr", f"sync with the plain gather: {CTR_STEPS} losses bit-equal "
        "to the kernel run's")

    # the CPU's plain path, the same arithmetic in another summation order
    cpu = train_ctr_ps(cfg, steps=CTR_STEPS, mode="sync", device="cpu")
    dl = max(abs(a - b) for a, b in zip(cpu["losses"],
                                        runs["sync"]["losses"]))
    check(dl <= 1e-4, f"card vs CPU losses differ by {dl:.3e} > 1e-4")
    say("ctr", f"sync on the CPU's plain path: max|dloss| {dl:.3e} over "
        f"{CTR_STEPS} steps (atol 1e-4); {cpu['steps_per_sec']:.1f} steps/s")

    # learning: 200 steps are too short for the zipf tail's rows to learn
    # (the reference's 200-step trajectory is flat too); 1,000 are not
    learn, learn_launches = counted_ctr(
        torch, bk, "learning run (sync, kernel)",
        lambda: train_ctr_ps(cfg, steps=CTR_LEARN_STEPS, mode="sync",
                             device="cuda"))
    head = statistics.fmean(learn["losses"][:100])
    tail = statistics.fmean(learn["losses"][-100:])
    check(learn["losses"][:CTR_STEPS] == runs["sync"]["losses"],
          "the learning run's first 200 losses differ from the sync run's")
    check(tail < head - 0.002, f"loss did not fall over {CTR_LEARN_STEPS} "
          f"steps: first 100 mean {head:.4f}, last 100 {tail:.4f}")
    say("ctr", f"learning: mean loss of the first 100 steps {head:.4f}, of "
        f"the last 100 {tail:.4f}")

    # shard servers as processes: the same values as in-process
    mp, mp_launches = counted_ctr(
        torch, bk, "multiproc (train_sparse_ps, sync, 4 shard processes)",
        lambda: train_sparse_ps(steps=CTR_MP_STEPS, sync=True,
                                repin_interval=20, transport="multiproc",
                                log_every=0, device="cuda"))
    check(mp["repins"] == 2, f"multiproc: {mp['repins']} re-pins, not 2")
    check(mp["losses"] == runs["sync"]["losses"][:CTR_MP_STEPS],
          "multiproc losses differ from the in-process run's")
    say("ctr", "multiproc: losses bit-equal to the in-process run's")

    # a profiled window of sync steps (the table built before it)
    table = make_table(cfg, 4, device="cuda")
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            win = train_ctr_ps(cfg, steps=60, mode="sync", table=table)
    finally:
        table.close()
    steps = win["steps"]
    dev_ms, split, kl = device_split(torch, prof, steps, "ctr")
    # the idle share against the unprofiled sync run's step time (the
    # profiler's own host cost stays out of it)
    wall_ms = 1e3 / runs["sync"]["steps_per_sec"]
    idle = 1.0 - dev_ms / wall_ms
    parts = ", ".join(f"{n} {t:.4f}" for n, t in split.items() if t)
    say("profile", f"ctr sync step: host clock {wall_ms:.3f} ms/step "
        f"unprofiled ({win['seconds'] * 1e3 / steps:.3f} in the 60 profiled "
        f"steps, re-pin at 50: pull "
        f"{win['pull_seconds'] / steps * 1e3:.3f} ms, push "
        f"{win['push_seconds'] / steps * 1e3:.3f} ms); device busy "
        f"{dev_ms:.4f} ms/step ({parts}); device idle share {idle:.4f}; "
        f"{kl:.0f} kernel launches/step")
    return {"launches": launches, "mp_launches": mp_launches,
            "learn_launches": learn_launches, "runs": runs,
            "idle_share": idle}


# --------------------------------------------------------------------------
# phase 7: timing at the serve shapes
# --------------------------------------------------------------------------


def time_ms(torch, fn, inputs, reps: int = 5, iters: int = 40) -> float:
    """Median over ``reps`` of the mean time of ``iters`` calls, rotating
    over ``inputs`` (sets of arguments larger together than the 50 MB L2,
    so each call reads its K/V from device memory as a decode step does)."""
    for args in inputs:
        fn(*args)
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for i in range(iters):
            fn(*inputs[i % len(inputs)])
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def phase_timing(torch, pk):
    F = torch.nn.functional
    B, KV, G, hd, ps, P = 8, 8, 4, 64, 16, 128
    pos = [2047, 1500, 1023, 700, 333, 64, 15, 0]
    sets = [paged_inputs(torch, B=B, KV=KV, G=G, hd=hd, ps=ps, P=P,
                         q_pos=pos, dtype=torch.float32, seed=100 + i)
            for i in range(4)]
    kern = time_ms(torch, lambda *a: pk.paged_decode_cuda(*a), sets)
    plain = time_ms(torch, lambda *a: pk.paged_decode_gather(*a), sets)

    # library yardstick: SDPA over the gathered, GQA-expanded K/V
    def gathered(q, kp, vp, table, qp):
        S = P * ps
        k = kp[table.long()].reshape(B, S, KV, hd)
        v = vp[table.long()].reshape(B, S, KV, hd)
        k = k.permute(0, 2, 1, 3).repeat_interleave(G, dim=1)
        v = v.permute(0, 2, 1, 3).repeat_interleave(G, dim=1)
        mask = (torch.arange(S, device="cuda")[None] <= qp[:, None].long())
        return (q.reshape(B, KV * G, 1, hd), k.contiguous(), v.contiguous(),
                mask[:, None, None, :])

    lib_sets = [gathered(*s) for s in sets[:2]]
    lib = time_ms(torch, lambda q, k, v, m: F.scaled_dot_product_attention(
        q, k, v, attn_mask=m), lib_sets)
    o_lib = F.scaled_dot_product_attention(*lib_sets[0][:3],
                                           attn_mask=lib_sets[0][3])
    ref = pk.paged_decode_gather(*sets[0]).reshape(B, KV * G, 1, hd)
    check((o_lib - ref).abs().max().item() <= 1e-3,
          "library yardstick disagrees with the gather")

    # the least time for this work: the K/V rows at positions 0..q_pos
    # (no window here), the live page-table entries, q, out and q_pos once
    # over the memory rate, or the flops over the f32 rate
    el = 4
    rows = sum(min(p, P * ps - 1) + 1 for p in pos)
    live_pages = sum(min(p // ps, P - 1) + 1 for p in pos)
    nbytes = (2 * rows * KV * hd * el + 2 * B * KV * G * hd * el
              + live_pages * 4 + B * 4)
    flops = 4 * rows * KV * G * hd
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS * 1e3
    bound = max(t_bytes, t_ops)
    by = "bytes" if t_bytes >= t_ops else "operations"
    say("timing", f"paged_decode at B{B} KV{KV} G{G} hd{hd} ps{ps} float32, "
        f"q_pos up to 2047: kernel {kern:.4f} ms, bound {bound:.4f} ms "
        f"({by}: {nbytes} bytes), gather {plain:.4f} ms, "
        f"sdpa on gathered K/V {lib:.4f} ms")
    return {"ms": kern, "plain_ms": plain, "bound_ms": bound, "bound_by": by,
            "library_ms": lib}


def time_cold_ms(torch, fn, args, flush, reps: int = 30) -> float:
    """Median over ``reps`` calls of one call's time (CUDA events around
    the call), with the L2 cache flushed before each by writing ``flush``
    (larger than the 50 MB L2), so every call meets its inputs and its
    output in device memory, as a decode step or prefill does.  Ten
    flushed calls first bring the card out of idle."""
    for _ in range(10):
        flush.zero_()
        fn(*args)
    torch.cuda.synchronize()
    events = []
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(*args)
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def phase_moe_timing(torch, mk):
    """Both MoE kernels at olmoe-1b-7b's decode (4 slots, one token each)
    and 512-token prefill shapes, float32, beside the least bytes each
    function needs at 3.35 TB/s, the plain version's time and one library
    call that computes the same function: ``F.embedding_bag`` in sum mode
    with per-sample weights over the flattened rows (dispatch: bags of
    one source row weighted by slot_w; combine: bags of a token's K slab
    rows weighted by w), its flat indices built before the timer starts
    and clamped as the kernels clamp."""
    from repro_torch.nn import moe as nn_moe

    F = torch.nn.functional

    def bag(table, idx, wts):
        return F.embedding_bag(idx, table, per_sample_weights=wts,
                               mode="sum")

    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")
    res = {"moe_dispatch": {}, "moe_combine": {}}
    el, D = 4, 2048
    for shape, G, S in (("decode", 4, 1), ("prefill", 1, 512)):
        x, src, sw, eid, pos, w, C = moe_inputs(
            torch, nn_moe, mk, G=G, S=S, D=D, E=64, K=8, cf=1.25,
            dtype=torch.float32, seed=11)
        E, K = 64, 8
        buf = mk.moe_dispatch_cuda(x, src, sw)
        # dispatch: the slab written, each distinct source row it reads
        # (empty slots read row 0), slot_src and slot_w once
        rows = sum(torch.unique(src[g].clamp(0, S - 1)).numel()
                   for g in range(G))
        d_bytes = G * E * C * D * el + rows * D * el + G * E * C * 8
        d_ops = G * E * C * D
        # combine: each distinct expert row it reads, the output, eid, pos
        # and w once
        flat = (torch.arange(G, device="cuda")[:, None, None] * E * C
                + eid.long().clamp(0, E - 1) * C + pos.long().clamp(0, C - 1))
        c_rows = torch.unique(flat).numel()
        c_bytes = c_rows * D * el + G * S * D * el + G * S * K * 12
        c_ops = 2 * G * S * K * D
        # the library call's inputs: flat row ids into x / the slab
        d_idx = (torch.arange(G, device="cuda")[:, None, None] * S
                 + src.long().clamp(0, S - 1)).reshape(-1, 1)
        d_lib = (x.reshape(-1, D), d_idx, sw.reshape(-1, 1))
        c_lib = (buf.reshape(-1, D), flat.reshape(-1, K), w.reshape(-1, K))
        for name, fn, plain, args, lib_args, nbytes, ops in (
                ("moe_dispatch", mk.moe_dispatch_cuda, mk.dispatch_slot,
                 (x, src, sw), d_lib, d_bytes, d_ops),
                ("moe_combine", mk.moe_combine_cuda, mk.combine_slot,
                 (buf, eid, pos, w), c_lib, c_bytes, c_ops)):
            want = plain(*args)
            got = bag(*lib_args).reshape(want.shape)
            err = (got - want).abs().max().item()
            check(err <= MOE_TOL["float32"], f"{name} {shape}: embedding_bag "
                  f"disagrees with the plain version by {err:.3e}")
            kern = time_cold_ms(torch, fn, args, flush)
            plain_ms = time_cold_ms(torch, plain, args, flush)
            lib_ms = time_cold_ms(torch, bag, lib_args, flush)
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            t_ops = ops / F32_FLOPS * 1e3
            bound = max(t_bytes, t_ops)
            by = "bytes" if t_bytes >= t_ops else "operations"
            res[name][shape] = {"ms": kern, "plain_ms": plain_ms,
                                "bound_ms": bound, "bound_by": by,
                                "library_ms": lib_ms, "bytes": nbytes}
            say("timing", f"{name} at olmoe {shape} G{G} S{S} E{E} K{K} C{C} "
                f"D{D} float32: kernel {kern:.4f} ms, bound {bound:.4f} ms "
                f"({by}: {nbytes} bytes), plain version {plain_ms:.4f} ms, "
                f"embedding_bag {lib_ms:.4f} ms")
    return res


def phase_flash_timing(torch, fk):
    """The three flash entry points at llama3.2-1b's training shape (one
    microbatch: 4 x 32 heads x 2048 x hd 64, causal), float32 and bfloat16,
    beside their bounds and plain versions, and the backward as a whole
    (the dK/dV pass plus the dQ pass) beside its bound, the plain backward
    and one library call.  The library call is
    ``F.scaled_dot_product_attention``: its forward for the forward, its
    autograd backward for the whole backward; timed only, used nowhere in
    the port.  No library call computes one pass alone, so each pass's
    ``library_ms`` is null; its plain version is autograd of the plain
    version asked for that pass's outputs only (dK and dV, or dQ).  Each
    input is 67 MB (float32), larger than the 50 MB L2.

    Bounds, from this run's causal mask (S(S+1)/2 visible pairs per
    head): each product (QKᵀ, PV, dO Vᵀ, dV, dK, dQ) is 2·hd flops a
    visible pair; the forward does 2 of them (2·B·H·S²·hd), the dK/dV pass
    4 (S, dP, dV, dK), the dQ pass 3 (S, dP, dQ); the backward as a whole
    needs 5 (2.5 x the forward).  Rates: 67 TFLOP/s float32 (CUDA cores),
    989 TFLOP/s bfloat16 (dense tensor cores), 3.35 TB/s."""
    F = torch.nn.functional
    B, H, S, hd = 4, 32, 2048, 64
    BH, pairs = B * H, S * (S + 1) // 2
    res = {}
    for dname, peak in (("float32", F32_FLOPS), ("bfloat16", BF16_TC_FLOPS)):
        dt = getattr(torch, dname)
        el = torch.finfo(dt).bits // 8
        g = torch.Generator(device="cuda")
        g.manual_seed(5)
        q, k, v, do = (torch.randn((B, H, S, hd), generator=g,
                                   device="cuda").to(dt) for _ in range(4))
        o, lse = fk.flash_fwd_cuda(q, k, v, causal=True)
        _, _, delta = fk.flash_bwd_dkdv_cuda(q, k, v, o, lse, do, causal=True)
        mat = BH * S * hd * el          # one (B, H, S, hd) tensor's bytes
        row = BH * S * 4                # lse or delta
        work = {                        # (flops, bytes) per entry point
            "flash_fwd": (4 * BH * pairs * hd, 4 * mat + row),
            "flash_bwd_dkdv": (8 * BH * pairs * hd, 7 * mat + 2 * row),
            "flash_bwd_dq": (6 * BH * pairs * hd, 5 * mat + 2 * row),
            "backward_total": (10 * BH * pairs * hd, 8 * mat + row),
        }
        kern = {
            "flash_fwd": time_ms(torch, lambda: fk.flash_fwd_cuda(
                q, k, v, causal=True), [()], reps=5, iters=3),
            "flash_bwd_dkdv": time_ms(torch, lambda: fk.flash_bwd_dkdv_cuda(
                q, k, v, o, lse, do, causal=True), [()], reps=5, iters=3),
            "flash_bwd_dq": time_ms(torch, lambda: fk.flash_bwd_dq_cuda(
                q, k, v, do, lse, delta, causal=True), [()], reps=5, iters=3),
        }
        kern["backward_total"] = kern["flash_bwd_dkdv"] + kern["flash_bwd_dq"]
        qkv = [t.clone().requires_grad_(True) for t in (q, k, v)]
        out = fk.flash_attention_ref(*qkv, causal=True)

        def plain_grads(wrt):
            return time_ms(torch, lambda: torch.autograd.grad(
                out, wrt, do, retain_graph=True), [()], reps=3, iters=2)

        plain = {
            "flash_fwd": time_ms(torch, lambda: fk.flash_attention_ref(
                q, k, v, causal=True), [()], reps=3, iters=2),
            "flash_bwd_dkdv": plain_grads(qkv[1:]),
            "flash_bwd_dq": plain_grads(qkv[:1]),
            "backward_total": plain_grads(qkv),
        }
        lib_out = F.scaled_dot_product_attention(*qkv, is_causal=True)
        err = (lib_out.float() - out.float()).abs().max().item()
        check(err <= 10 * FLASH_TOL[dname], f"sdpa {dname} disagrees with "
              f"the plain version by {err:.3e}")
        lib = {
            "flash_fwd": time_ms(torch, lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=True), [()], reps=5, iters=3),
            "flash_bwd_dkdv": None, "flash_bwd_dq": None,
            "backward_total": time_ms(torch, lambda: torch.autograd.grad(
                lib_out, qkv, do, retain_graph=True), [()], reps=5, iters=3),
        }
        del out, lib_out, qkv
        for name, (flops, nbytes) in work.items():
            t_ops = flops / peak * 1e3
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            res.setdefault(name, {})[dname] = {
                "ms": kern[name], "plain_ms": plain[name],
                "bound_ms": max(t_ops, t_bytes),
                "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                "library_ms": lib[name], "flops": flops, "bytes": nbytes}
            sdpa = "none" if lib[name] is None else f"{lib[name]:.4f} ms"
            say("timing", f"{name} at B{B} H{H} S{S} hd{hd} causal {dname}: "
                f"kernel {kern[name]:.4f} ms, bound "
                f"{max(t_ops, t_bytes):.4f} ms ({flops} flops, {nbytes} "
                f"bytes), plain {plain[name]:.4f} ms, sdpa {sdpa}")
        del q, k, v, do, o, lse, delta
        torch.cuda.empty_cache()
    return res


def phase_bag_timing(torch, bk):
    """embedding_bag in float32 at the CTR hot-cache lookup, the reference
    benchmark's pooled shape (benchmarks/bench_kernels.py) and a large
    pooled shape, beside its byte bound, the plain version and
    ``F.embedding_bag(mode="sum")``; L2 flushed before each call."""
    F = torch.nn.functional
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")
    g = torch.Generator(device="cuda")
    g.manual_seed(3)
    res = {}
    for label, N, bag, V, dim in (
            ("ctr hot-cache lookup", 6656, 1, 4096, 16),
            ("bench pooled", 256, 26, 100_000, 128),
            ("large pooled", 16_384, 26, 1_000_000, 128)):
        ids = torch.randint(0, V, (N, bag), generator=g, device="cuda",
                            dtype=torch.int32)
        table = torch.randn((V, dim), generator=g, device="cuda")
        ids64 = ids.long()
        lib = F.embedding_bag(ids64, table, mode="sum")
        want = bk.embedding_bag_ref(ids, table)
        err = (lib - want).abs().max().item()
        check(err <= BAG_TOL["float32"], f"{label}: F.embedding_bag "
              f"disagrees with the plain version by {err:.3e}")
        kern = time_cold_ms(torch, bk.embedding_bag_cuda, (ids, table), flush)
        plain = time_cold_ms(torch, bk.embedding_bag_ref, (ids, table), flush)
        lib_ms = time_cold_ms(
            torch, lambda i, t: F.embedding_bag(i, t, mode="sum"),
            (ids64, table), flush)
        # the least bytes: the ids, each distinct row they name, the output
        rows = torch.unique(ids).numel()
        nbytes = N * bag * 4 + rows * dim * 4 + N * dim * 4
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = N * bag * dim / F32_FLOPS * 1e3
        bound = max(t_bytes, t_ops)
        by = "bytes" if t_bytes >= t_ops else "operations"
        res[label] = {"ms": kern, "plain_ms": plain, "bound_ms": bound,
                      "bound_by": by, "library_ms": lib_ms, "bytes": nbytes,
                      "shape": f"N{N} bag{bag} V{V} dim{dim}"}
        say("timing", f"embedding_bag {label} N{N} bag{bag} V{V} dim{dim} "
            f"float32: kernel {kern:.4f} ms, bound {bound:.4f} ms ({by}: "
            f"{nbytes} bytes, {rows} distinct rows), plain {plain:.4f} ms, "
            f"F.embedding_bag {lib_ms:.4f} ms")
        del ids, ids64, table, lib, want
        torch.cuda.empty_cache()
    return res


def main() -> int:
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found; run from a "
              "checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. device
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    say("device", f"{name} x{count}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}")
    smi_line = smi.stdout.strip().splitlines()[0]
    print(smi_line, flush=True)

    # 2. build: one nvcc per kernel source, all started together
    from repro_torch.kernels import _build
    from repro_torch.kernels import embedding_bag as bk
    from repro_torch.kernels import flash_attention as fk
    from repro_torch.kernels import moe as mk
    from repro_torch.kernels import paged_attention as pk

    t0 = time.perf_counter()
    _build.build_all(KERNELS)
    say("build", f"{', '.join(KERNELS)} built in "
        f"{time.perf_counter() - t0:.1f} s")
    for kernel in KERNELS:
        for line in _build.BUILD_LOG.get(kernel, "").splitlines():
            if "registers" in line or "spill" in line:
                say("build", f"{kernel}: {line.strip()}")
    counters = {"paged_decode": pk.paged_decode_cuda,
                "moe_dispatch": mk.moe_dispatch_cuda,
                "moe_combine": mk.moe_combine_cuda,
                "flash_fwd": fk.flash_fwd_cuda,
                "flash_bwd_dkdv": fk.flash_bwd_dkdv_cuda,
                "flash_bwd_dq": fk.flash_bwd_dq_cuda}

    # 3. kernels against their plain versions
    worst = phase_kernels(torch, pk)
    moe_worst = phase_moe_kernels(torch, mk)
    moe_bwd = phase_moe_backward(torch, mk)
    flash_worst = phase_flash_kernels(torch, fk)
    bag_worst = phase_bag_kernels(torch, bk)

    # 4.-5. llama3.2-1b, then its state is freed before olmoe's 27.7 GB
    llama_launches, state = phase_serve(torch, counters)
    phase_profile(torch, state, "llama3.2-1b")
    del state
    torch.cuda.empty_cache()

    # 6. olmoe-1b-7b
    moe_launches, state = phase_moe(torch, counters)
    phase_profile(torch, state, "olmoe-1b-7b")
    del state
    torch.cuda.empty_cache()

    # 7.-9. training: the main path of this slice, the teacher checks and
    # a profiled step
    train_launches, _, _ = phase_train(torch, counters)
    torch.cuda.empty_cache()
    teacher = phase_teacher(torch, counters)
    phase_train_profile(torch)
    torch.cuda.empty_cache()

    # 10. CTR training over the parameter server
    ctr = phase_ctr(torch, bk)
    torch.cuda.empty_cache()

    # 11. timing
    timing = phase_timing(torch, pk)
    moe_timing = phase_moe_timing(torch, mk)
    flash_timing = phase_flash_timing(torch, fk)
    bag_timing = phase_bag_timing(torch, bk)

    paths = (("llama3.2-1b serve", llama_launches),
             ("olmoe-1b-7b serve", moe_launches),
             ("llama3.2-1b train", train_launches),
             ("olmoe-1b-7b 2-layer train check",
              teacher["olmoe-1b-7b"]["launches"]))
    by_path = {k: {p: n[k] for p, n in paths if n.get(k)} for k in counters}
    kernels = [{
        "name": "paged_decode", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/paged_decode.cu",
        "replaces": "src/repro/kernels/paged_attention.py:277",
        "launches": llama_launches["paged_decode"]
        + moe_launches["paged_decode"],
        "launches_by_path": by_path["paged_decode"],
        "max_abs_err": worst["float32"],
        "max_abs_err_bf16": worst["bfloat16"], **timing,
        "shape": "llama3.2-1b decode, B8 KV8 G4 hd64, q_pos up to 2047",
    }]
    TIMED = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    for kname, line in (("moe_dispatch", 119), ("moe_combine", 170)):
        t = moe_timing[kname]
        kernels.append({
            "name": kname, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/moe.cu",
            "replaces": f"src/repro/kernels/moe.py:{line}",
            "launches": moe_launches[kname],
            "launches_by_path": by_path[kname],
            "max_abs_err": moe_worst[kname]["float32"],
            "max_abs_err_bf16": moe_worst[kname]["bfloat16"],
            "max_abs_err_backward": moe_bwd,
            **{k: t["decode"][k] for k in TIMED},
            "shape": "olmoe-1b-7b decode, G4 S1 E64 K8 C8 D2048",
            "prefill": {k: t["prefill"][k] for k in TIMED},
        })
    for kname in ("flash_fwd", "flash_bwd_dkdv", "flash_bwd_dq"):
        t = flash_timing[kname]
        kernels.append({
            "name": kname, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:85",
            "launches": train_launches[kname],
            "launches_by_path": by_path[kname],
            "max_abs_err": flash_worst[kname]["float32"],
            "max_abs_err_bf16": flash_worst[kname]["bfloat16"],
            **{k: t["float32"][k] for k in TIMED},
            "shape": "llama3.2-1b training microbatch, B4 H32 S2048 hd64, "
                     "causal, float32",
            "bfloat16": {k: t["bfloat16"][k] for k in TIMED},
        })
        if kname != "flash_fwd":
            total = flash_timing["backward_total"]
            kernels[-1]["backward_total"] = {
                "parts": ["flash_bwd_dkdv", "flash_bwd_dq"],
                **{k: total["float32"][k] for k in TIMED},
                "bfloat16": {k: total["bfloat16"][k] for k in TIMED}}
    t = bag_timing["ctr hot-cache lookup"]
    kernels.append({
        "name": "embedding_bag", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/embedding_bag.cu",
        "replaces": "src/repro/kernels/embedding_bag.py:43",
        "launches": sum(ctr["launches"].values()),
        "launches_by_path": {f"ctr train_sparse_ps {m}, {CTR_STEPS} steps": n
                             for m, n in ctr["launches"].items()},
        "max_abs_err": bag_worst["float32"],
        "max_abs_err_bf16": bag_worst["bfloat16"],
        **{k: t[k] for k in TIMED}, "shape": t["shape"] + " (CTR hot-cache "
        "lookup), float32",
        **{label: bag_timing[label] for label in ("bench pooled",
                                                   "large pooled")},
    })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
