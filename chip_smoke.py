#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its own line; any failure exits nonzero before the
result lines:

1. device  — the card's name, count, and ``nvidia-smi``'s name and power
             limit;
2. build   — builds the CUDA kernel of the serve path from
             ``src/repro_torch/kernels/csrc`` with nvcc;
3. kernels — each kernel against its plain PyTorch version on the card,
             at the test shapes and at llama3.2-1b's full-width decode
             shape, in float32 (atol 2e-5) and bfloat16 (atol 2e-2);
4. serve   — ``serve_continuous`` of llama3.2-1b at full width (16
             layers, d_model 2048, random weights from a seed, float32) on
             a mix of prompts of 64-512 tokens, counting kernel launches
             (must be 16 per decode step), plus a teacher-forced
             ``decode_step`` through the kernel and through the gather;
5. profile — host clock vs profiled device time of full-width decode
             steps (device idle share, launches per step);
6. timing  — the kernel at the llama shape beside its bound, its plain
             version and a library call (CUDA events, median of repeats).

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


# --------------------------------------------------------------------------
# phase 4: the main path
# --------------------------------------------------------------------------

REQUESTS = [(64, 32), (512, 32), (128, 32), (300, 32), (96, 32), (448, 32),
            (200, 32), (256, 32)]


def phase_serve(torch, pk):
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import serve_continuous
    from repro_torch.models import decoder as dec

    cfg = get_config("llama3.2-1b", reduced=False)
    t0 = time.perf_counter()
    params = dec.init_model(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    say("serve", f"llama3.2-1b full width: {cfg.num_layers} layers, d_model "
        f"{cfg.d_model}, vocab {cfg.vocab}, float32 weights from seed 0 in "
        f"{time.perf_counter() - t0:.1f} s")
    # the same mix once first: CUDA start-up and the first use of every
    # matmul shape stay out of the measured run
    t0 = time.perf_counter()
    serve_continuous("llama3.2-1b", reduced=False, device="cuda",
                     requests=REQUESTS, slots=4)
    say("serve", f"warm-up run of the same mix: {time.perf_counter() - t0:.2f}"
        " s")

    pk.paged_decode_cuda.launches = 0
    out = serve_continuous("llama3.2-1b", reduced=False, device="cuda",
                           requests=REQUESTS, slots=4)
    launches = pk.paged_decode_cuda.launches
    check(out["outcomes"] == ["completed"] * len(REQUESTS),
          f"outcomes {out['outcomes']}")
    check(out["generated"] == [g for _, g in REQUESTS],
          f"generated {out['generated']}")
    check(out["tokens_in_vocab"], "tokens outside the vocabulary")
    check(out["pool_conserved"], "page pool not conserved")
    steps = out["decode_steps"]
    layers = cfg.num_layers
    check(steps > 0 and launches == layers * steps,
          f"kernel launches {launches} != {layers} x {steps} steps")
    ttft = [t for t in out["ttft_s"] if t is not None]
    toks = sum(out["generated"])
    say("serve", f"{len(REQUESTS)} requests completed, {toks} tokens, "
        f"{steps} decode steps, paged_decode launches {launches} "
        f"(= {layers} x {steps})")
    say("serve", f"decode tok/s {toks / out['decode_s']:.1f} (inside decode "
        f"chunks, 4 slots), {out['decode_tok_per_s']:.1f} (whole run incl. "
        f"prefills); TTFT p50 {statistics.median(ttft) * 1e3:.1f} ms, max "
        f"{max(ttft) * 1e3:.1f} ms (all arrive at t=0); wall "
        f"{out['wall_s']:.2f} s")

    # teacher-forced: one decode step on one cache, kernel vs gather
    plens = [512, 300, 150, 77]
    B = len(plens)
    cfg_p = dataclasses.replace(cfg, kv_impl="paged")
    cache = dec.init_cache(cfg_p, B, 576, dtype=torch.float32,
                           device="cuda")
    g = torch.Generator(device="cuda")
    g.manual_seed(1)
    prompts = torch.randint(0, cfg.vocab, (B, max(plens)), generator=g,
                            device="cuda", dtype=torch.int32)
    lg, cache = dec.prefill(params, cfg_p, prompts, cache,
                            lengths=torch.tensor(plens, device="cuda"),
                            compute_dtype=torch.float32)
    tok = torch.stack([lg[b, plens[b] - 1, :cfg.vocab].argmax()
                       for b in range(B)]).to(torch.int32)[:, None]
    n0 = pk.paged_decode_cuda.launches
    la, _ = dec.decode_step(params, cfg_p, tok, cache,
                            compute_dtype=torch.float32, impl="auto")
    lb, _ = dec.decode_step(params, cfg_p, tok, cache,
                            compute_dtype=torch.float32, impl="gather")
    torch.cuda.synchronize()
    check(pk.paged_decode_cuda.launches - n0 == layers,
          "impl='auto' did not launch the kernel in every layer")
    check(bool(torch.isfinite(la).all()), "non-finite decode logits")
    err = (la - lb).abs().max().item()
    check(err <= 1e-3, f"decode_step logits kernel vs gather {err:.3e} > 1e-3")
    say("serve", f"teacher-forced decode_step, kernel vs gather: max|dlogit| "
        f"{err:.3e} (atol 1e-3)")
    return launches, (params, cfg_p, cache, tok)


# --------------------------------------------------------------------------
# phase 5: where a decode step's time goes
# --------------------------------------------------------------------------


def phase_profile(torch, state, steps: int = 8):
    """Host clock of ``steps`` decode steps at full width (4 slots, KV
    lengths 77-512) beside the device time the profiler sees in them."""
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
    dev_us, launches, paged_us, gemm_us = 0.0, 0, 0.0, 0.0
    for e in prof.key_averages():
        if e.key in ("cudaLaunchKernel", "cuLaunchKernel",
                     "cuLaunchKernelEx", "cudaLaunchKernelExC"):
            launches += e.count
        if e.device_type != DeviceType.CUDA:
            continue
        t = e.self_device_time_total
        dev_us += t
        if "paged_decode" in e.key:
            paged_us += t
        elif "gemm" in e.key.lower() or "gemv" in e.key.lower():
            gemm_us += t
    dev_ms = dev_us / 1e3 / steps
    idle = 1.0 - dev_ms / wall_ms if dev_us else float("nan")
    say("profile", f"decode step at full width, 4 slots: host clock "
        f"{wall_ms:.2f} ms/step; device busy {dev_ms:.3f} ms/step "
        f"(matmul kernels {gemm_us / 1e3 / steps:.3f}, paged_decode "
        f"{paged_us / 1e3 / steps:.3f}); device idle share {idle:.3f}; "
        f"{launches / steps:.0f} kernel launches/step")


# --------------------------------------------------------------------------
# phase 6: timing at the llama shape
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
    print(smi.stdout.strip().splitlines()[0], flush=True)

    # 2. build
    from repro_torch.kernels import _build
    from repro_torch.kernels import paged_attention as pk

    t0 = time.perf_counter()
    _build.build("paged_decode")
    say("build", f"paged_decode built in {time.perf_counter() - t0:.1f} s")
    for line in _build.BUILD_LOG.get("paged_decode", "").splitlines():
        if "registers" in line or "spill" in line:
            say("build", line.strip())

    # 3.-6.
    worst = phase_kernels(torch, pk)
    launches, state = phase_serve(torch, pk)
    phase_profile(torch, state)
    timing = phase_timing(torch, pk)

    kernels = [{
        "name": "paged_decode", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/paged_decode.cu",
        "replaces": "src/repro/kernels/paged_attention.py:277",
        "launches": launches, "max_abs_err": worst["float32"], **timing,
    }]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
