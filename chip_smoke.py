#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its own line; any failure exits nonzero before the
result lines:

1. device  — the card's name, count, and ``nvidia-smi``'s name and power
             limit;
2. build   — builds the CUDA kernels of the serve paths
             (``src/repro_torch/kernels/csrc/*.cu``), one nvcc each, all
             started together;
3. kernels — each kernel against its plain PyTorch version on the card:
             paged decode at the test shapes and the llama3.2-1b and
             olmoe-1b-7b decode shapes, float32 (atol 2e-5) and bfloat16
             (atol 2e-2); MoE dispatch and combine at the reference test
             sweep, olmoe-1b-7b's decode and prefill shapes and with
             out-of-range indices, float32 (atol 1e-5) and bfloat16
             (atol 5e-2);
4. serve   — ``serve_continuous`` of llama3.2-1b at full width (16
             layers, d_model 2048, random weights from a seed, float32) on
             a mix of prompts of 64-512 tokens, counting kernel launches
             (must be 16 per decode step), plus a teacher-forced
             ``decode_step`` through the kernel and through the gather;
5. profile — host clock vs profiled device time of full-width llama
             decode steps (device idle share, launches per step);
6. moe     — the same mix served by olmoe-1b-7b at full width (16 layers,
             64 experts, top-8, float32), counting launches (MoE kernels
             16 per decode step and per prefill, paged decode 16 per
             decode step), a teacher-forced prefill and ``decode_step``
             through the kernels against the plain versions, and a
             profiled decode step split by kernel;
7. timing  — each kernel at its serve shapes beside its bound, its plain
             version and, where one exists, a library call (CUDA events,
             median of repeats, L2 flushed).

It then prints one ``{"kernels": [...]}`` JSON line and, last, the
``{"ok": true, "device": {...}}`` line.  Imports neither jax nor the JAX
package.
"""

from __future__ import annotations

import dataclasses
import json
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
KERNELS = ("paged_decode", "moe")           # csrc/<name>.cu


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

    cfg = get_config("olmoe-1b-7b", reduced=False)
    t0 = time.perf_counter()
    params = dec.init_model(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    n_par = sum(t.numel() for t in _leaves(params))
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
    say("moe", f"launches: moe_dispatch = moe_combine = {layers} x ({steps} "
        f"+ {pre}) = {launches['moe_dispatch']}, paged_decode = {layers} x "
        f"{steps} = {launches['paged_decode']}")

    # teacher-forced: batched prefill (one routing group of up to 512
    # tokens per sequence, drops included) and one decode step, through
    # the kernels and through moe_impl="slot" + the gather
    plens = [512, 300, 150, 77]
    cfg_p = dataclasses.replace(cfg, kv_impl="paged")
    cfg_s = dataclasses.replace(cfg_p, moe_impl="slot")
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
    check(all(fn.launches - n0[k] == layers for k, fn in counters.items()),
          "decode_step did not launch every kernel in every layer")
    check(bool(torch.isfinite(da).all()), "non-finite olmoe decode logits")
    errs.append((da - db).abs().max().item())
    check(max(errs) <= 1e-3, f"olmoe teacher-forced logits, kernels vs plain "
          f"versions: prefill {errs[0]:.3e}, decode {errs[1]:.3e} > 1e-3")
    say("moe", f"teacher-forced prefill (prompts {plens}) and decode_step, "
        f"kernels vs plain versions: max|dlogit| prefill {errs[0]:.3e}, "
        f"decode {errs[1]:.3e} (atol 1e-3)")
    return launches, (params, cfg_p, cache, tok)


def _leaves(tree):
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    if isinstance(tree, (tuple, list)):
        return [t for v in tree for t in _leaves(v)]
    return [tree]


# --------------------------------------------------------------------------
# phase 5: where a decode step's time goes
# --------------------------------------------------------------------------

#: kernel-name fragments of the profile's device-time split, checked in
#: this order ("rest" takes what matches none)
PROFILE_SPLIT = (("paged_decode", ("paged_decode",)),
                 ("moe_dispatch", ("dispatch_kernel",)),
                 ("moe_combine", ("combine_kernel",)),
                 ("matmul", ("gemm", "gemv")))


def phase_profile(torch, state, label: str, steps: int = 8):
    """Host clock of ``steps`` decode steps at full width (4 slots, KV
    lengths 77-512) beside the device time the profiler sees in them,
    split by kernel."""
    from torch.autograd import DeviceType
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
    dev_ms = dev_us / 1e3 / steps
    idle = 1.0 - dev_ms / wall_ms
    parts = ", ".join(f"{n} {t / 1e3 / steps:.3f}" for n, t in split.items()
                      if t or n in ("matmul", "paged_decode", "rest"))
    say("profile", f"{label} decode step at full width, 4 slots: host clock "
        f"{wall_ms:.2f} ms/step; device busy {dev_ms:.3f} ms/step ({parts}); "
        f"device idle share {idle:.3f}; {launches / steps:.0f} kernel "
        f"launches/step")


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
                "moe_combine": mk.moe_combine_cuda}

    # 3. kernels against their plain versions
    worst = phase_kernels(torch, pk)
    moe_worst = phase_moe_kernels(torch, mk)

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

    # 7. timing
    timing = phase_timing(torch, pk)
    moe_timing = phase_moe_timing(torch, mk)

    by_path = {k: {"llama3.2-1b": llama_launches[k],
                   "olmoe-1b-7b": moe_launches[k]} for k in counters}
    kernels = [{
        "name": "paged_decode", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/paged_decode.cu",
        "replaces": "src/repro/kernels/paged_attention.py:277",
        "launches": sum(by_path["paged_decode"].values()),
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
            **{k: t["decode"][k] for k in TIMED},
            "shape": "olmoe-1b-7b decode, G4 S1 E64 K8 C8 D2048",
            "prefill": {k: t["prefill"][k] for k in TIMED},
        })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
