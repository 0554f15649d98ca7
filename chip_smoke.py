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
3. kernels — each kernel against its plain PyTorch version on the card: paged
             decode at the test shapes, the llama3.2-1b and olmoe-1b-7b decode
             shapes, phase 16's decode shapes (G 16, 2 with gemma2-2b's
             window and soft cap at hd 256, 6 and 8), phase 17's (G 4 at hd
             128, whisper-large-v3's KV 20 at G 1) and sequences split
             over KV pages (across split boundaries,
             ending in the first split, a window starting mid-split, a table
             width that does not divide into the splits), float32 (atol 2e-5)
             and bfloat16 (atol 2e-2), each case bit-equal over two calls; MoE
             dispatch and combine at the reference test sweep, olmoe-1b-7b's,
             qwen3-moe-30b-a3b's and jamba-v0.1-52b's (E 16, top-2, D 4096)
             decode and prefill shapes and with
             out-of-range indices, float32
             (atol 1e-5) and bfloat16 (atol 5e-2), and bit-equal to the plain
             versions with the kernels' rounding (dispatch formed in float32
             and cast once; ``combine_slot_ordered``), on the contiguous and
             the strided slab, and over two calls; the MoE autograd Functions'
             dx / dbuf / dw against autograd of the slot versions at olmoe's
             prefill shape (float32 atol 1e-5, dw 1e-4) and, in bfloat16
             (within 4 bfloat16 ulps of each gradient's largest value), at
             olmoe's prefill and training and qwen3-moe's prefill shapes;
             flash attention forward at the reference sweep, partial tiles,
             head dim 32, olmoe's training heads at hd 128, gemma2-2b's
             4,608-token prefill with its window and soft cap, whisper-large-
             v3's encoder (non-causal, 4 x 20 heads x 1,500 frames) and the
             cross-attention of whisper-large-v3 and llama-3.2-vision-11b
             (512 queries over 1,500 / 1,601 keys) (float32 atol
             2e-5, bfloat16 2e-2) and its dq / dk / dv against autograd of
             the plain version (float32 atol 1e-4 rtol 1e-4 and max|err|
             2e-5, bfloat16 atol 5e-2 rtol 1.6e-2), bfloat16 also within 1
             ulp of the plain versions that make the kernels' roundings,
             every flash entry point bit-equal over two runs; embedding bag
             at the reference sweep, the CTR pulls, the benchmark's pooled
             shape, bags of 70 and 300 (past one stage), dims 5-256, each
             also on a table offset by one element (the fallback), duplicate
             and out-of-range ids (float32 atol 1e-5, bfloat16 5e-2, both
             widened past bag 26; a bag of one bit-equal to a gather), bit for
             bit equal to ``embedding_bag_ordered`` and over two calls;
4. cli     — ``python -m repro_torch.launch.serve`` (plain,
             ``--continuous`` and ``--continuous --replan``) and ``python -m
             repro_torch.launch.train`` with their defaults (reduced
             llama3.2-1b, head dim 32) as subprocesses on the card, then
             through their ``main`` in this process, counting the flash
             launches;
5. serve   — ``serve_continuous`` of llama3.2-1b at full width (16
             layers, d_model 2048, random weights from a seed, float32) on
             a mix of prompts of 64-512 tokens, counting kernel launches
             (paged decode 16 per decode step, flash forward 16 per
             prefill), plus a teacher-forced ``decode_step`` through the
             kernel and through the gather;
6. profile — host clock vs profiled device time of full-width llama
             decode steps (device idle share, launches per step);
7. moe     — the same mix served by olmoe-1b-7b at full width (16 layers,
             64 experts, top-8, float32), counting launches (MoE kernels,
             the position kernel with them, 16 per decode step and per
             prefill, paged decode 16 per decode step), a teacher-forced
             prefill and ``decode_step`` through the kernels against the
             plain versions, and a profiled decode step and a profiled
             512-token prefill split by kernel, with each MoE kernel's
             time per call in them;
8. train   — ``train("llama3.2-1b", reduced=False)`` on the card, float32
             with AdamW state on the card: 3 steps of 8 x 2048 tokens in
             microbatches of 4, counting the flash launches of every layer
             per step (forward twice: forward and remat recompute), finite
             losses and grad norms, peak memory;
9. teacher — one ``loss_fn`` and its gradients through the kernels against
             the plain versions on the card: llama3.2-1b and olmoe-1b-7b at
             full width and 2 layers;
10. train profile — one profiled full-width llama train step: host clock,
             device busy split by kernel, idle share;
11. ctr    — ``train_sparse_ps(steps=200)`` at ``CTRConfig()``'s full
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
             profiled window of 110 sync steps (device idle share, the
             embedding_bag's device time per call);
12. timing — each kernel at its main path's shapes beside its bound, its
             plain version and, where one exists, a library call (CUDA
             events, median of repeats, L2 flushed or exceeded); paged
             decode also in bfloat16 and at the llama serve shape; the
             float32 flash bounds at both the CUDA-core and the 3xTF32
             tensor-core rate (the lower time is the bound); the MoE
             kernels with median, min and p90 of their cold calls and a
             warm (back to back) time beside an empty kernel timed the
             same way, combine also on the strided slab; the embedding bag
             likewise at the CTR hot-cache lookup, two pooled shapes and
             long bags (those three also in bfloat16), each also after a
             flush that leaves L2 clean; phase 16's shapes: paged decode at
             the four archs' decode shapes in their dtypes, the flash
             forward and backward at gemma2-2b's prefill (hd 256, window
             4,096, soft cap 50; the library call eager ``flex_attention``,
             as SDPA takes no soft cap), MoE dispatch and combine at
             qwen3-moe-30b-a3b's decode and prefill in bfloat16; phase 17's
             shapes: paged decode at the three attention archs' decode
             shapes, the flash forward and backward at the whisper encoder
             and the two cross-attention shapes (non-causal; SDPA), MoE at
             jamba-v0.1-52b's decode and prefill in bfloat16; the MoE
             position-in-expert kernel at olmoe-1b-7b's training (8 x
             2,048 tokens) and decode shapes and qwen3-moe-30b-a3b's
             prefill, bit-equal to the one-hot cumsum, beside it and the
             bare ``cumsum`` of the one-hot;
13. sched  — the paper's Table-3 cases (MATCHNET, CTRDNN, 2EMB and NCE
             on the CPU + V100 fleet, MATCHNET on 32 resource types) in one
             ``RLScheduler().schedule_many`` call on the card (150 rounds x
             32 plans, two fleet-size groups): each plan's cost on the card
             against the NumPy ``plan_cost`` (rtol 1e-9) and no worse than
             the Greedy, Heuristic, GPU and CPU baselines;
             ``torch_cost.soft_cost`` of 4,096 random plans a model on the
             card against the CPU and the NumPy oracle (rtol 1e-9, the
             feasibility disagreements counted, none allowed that the
             search's re-verification would miss); per group the steady
             rounds/s, the first chunk's seconds, kernel launches and
             device time a round, wall time, beside the same search on the
             CPU and the unfused (NumPy-scored) loop;
14. replan — the serve CLI's ``--replan`` controller (the fused search on
             the card at start-up, a window every 0.5 s tuning admission)
             around full-width llama3.2-1b ``serve_continuous`` on phase 5's
             mix: requests completed, at least one window, an admission
             report, a feasible incumbent, the kernel launches of phase 5;
15. elastic — ``train_ctr_elastic`` at ``CTRConfig()`` on the card (3
             in-process shard servers, PS-hosted optimizers, one backup a
             bucket, the tower and the push's dedup on the card), with the
             launch counts set to 0 just before and read just after (none:
             the fleet has no hot cache): 200 sync adagrad steps calm, with
             a join at 40 and a kill at 80 (one recovery), under
             ``bench_chaos.py``'s masking schedule and under the loss of
             both replicas of every bucket with checkpoints every 5 steps
             (a restore and a replay), each bit-equal to the calm run's
             losses; 200 async adam steps with the join and the kill; the
             train CLI with its defaults over one shard process each and a
             kill, and with ``--replan`` (one calibration, one drift
             consideration for the kill); a shard process SIGKILLed with no
             traffic, detected by the heartbeat within its deadline and
             recovered bit-exactly;
16. archs  — chatglm3-6b (float32), gemma2-2b (float32), internlm2-20b
             (bfloat16) and qwen3-moe-30b-a3b (bfloat16) at full width and
             depth, random weights from seed 0, one model on the card at a
             time: ``serve_continuous`` on phase 5's mix (gemma2-2b: plus a
             4,608-token prompt, past its window of 4,096) with the launch
             counts of phase 5 and 7, a teacher-forced ``decode_step``
             through the kernels against the plain versions (float32 atol
             1e-3; bfloat16 within 16 ulps of the largest logit after 48
             layers, the greedy tokens' agreement printed), tok/s, TTFT,
             peak memory and a
             profiled decode step; a 2-layer full-width ``loss_fn`` with
             gradients of chatglm3-6b, gemma2-2b and internlm2-20b through
             the kernels against the plain versions (as phase 9); and
             olmoe-1b-7b trained at all 16 layers in bfloat16 (parameters
             and AdamW moments): the loss and gradient norm through the
             kernels against the plain versions before any update, then 3
             steps of 8 x 2048 tokens with the launches counted, s/step and
             peak memory;
17. mixers — rwkv6-7b, llama-3.2-vision-11b and whisper-large-v3
             (float32) at full width and depth and jamba-v0.1-52b
             (bfloat16) at full width and 16 of its 32 layers (its full
             depth does not fit the card), random weights from seed 0, one
             model on the card at a time: ``serve_continuous`` on phase
             5's mix with the launches counted by layer kind (paged decode
             per self-attention layer and decode step, the flash forward
             per self- and cross-attention layer and prefill, the MoE
             kernels per MoE layer), a teacher-forced ``decode_step``
             through the kernels against the plain versions and against
             the prefill of the same tokens, 16 greedy steps on both
             paths, a profiled decode step, the recurrent archs' 512-token
             prefill per layer and the one-token cross decode; a 2-layer
             full-width ``loss_fn`` with gradients of each (whisper-large-v3
             with 2 encoder layers over 1,500 frames, llama-3.2-vision-11b
             over 1,601 patches, jamba-v0.1-52b in bfloat16) through the
             kernels against the plain versions, rwkv6-7b against the CPU;
18. mesh   — the multi-device layer on a 1x1 (data, model) mesh over NCCL
             (world size 1: NCCL refuses two ranks on one card, so the
             2x2 mesh and the 4-stage pipeline are held on the CPU over
             gloo by the tests): phase 8's run again with the parameters
             and AdamW state as DTensors laid out by ``param_specs`` and
             the batches placed by ``shard_batch``, 3 steps under
             ``use_mesh`` (the flash kernels through ``local_map``,
             launches counted) against phase 8's losses and grad norms
             (bit-equal, else within 1e-5 relative), then one profiled
             sharded step beside phase 10's; a 2-layer full-width
             olmoe-1b-7b ``loss_fn`` with gradients on the mesh (the MoE
             kernels through ``local_map``) against the same unsharded;
             full-width llama3.2-1b ``make_prefill_step`` and
             ``make_serve_step`` (a dense cache laid out by
             ``cache_specs``) against the unsharded steps; a 1-stage
             ``pipeline_loss`` over NCCL against the stage function's own
             gradient; and the dry run of llama3.2-1b ``decode_32k`` and
             ``prefill_32k`` on the 16x16 fake-backend mesh with device
             type ``cuda`` (per-device memory, FLOPs, collective bytes,
             H100 roofline terms; the prefill's graph holds the flash
             kernel's custom op);
19. examples — the five ``repro_torch.examples`` through their ``main``
             at the reference's defaults with ``--device cuda``, then
             ``heterps_ctr_pipeline --chaos``, each with the launch counts
             set to 0 just before and read just after: ``serve_decode``
             (flash forward, MoE in jamba's reduced layer, paged decode),
             ``quickstart`` (the fused RL search, then 20 train steps of
             reduced llama3.2-1b: the flash forward twice and each
             backward pass once a layer and step), ``schedule_all_archs``
             (ten fused searches, no kernel), ``observability`` (two
             shard processes, open-loop serving, 3 trace lanes) and the
             CTR pipeline (2,000,000 x 32 table on 4 shards, 300 steps,
             one embedding_bag launch per pull that found the hot cache);
             their deterministic numbers against the reference's
             (``REF_*``: shapes, KV bytes, requests, the baselines' costs
             and plans at rtol 1e-12 / 1e-9, each RL cost against the
             NumPy ``plan_cost`` of its plan, re-pins and per-shard rows,
             the chaos drift of exactly 0); then ``python -m
             repro_torch.examples.serve_decode --device cuda`` as a
             subprocess.

The scheduler and the elastic fleet have no TPU kernel in the reference
(``jnp`` under ``jit``; no hot cache on the elastic path), so phases 13-15
add none: their device work is plain tensor code on the card.

    python3 chip_smoke.py --baseline OLD/moe.cu [--baseline ...]

builds each given earlier kernel source (named as its ``csrc/<name>.cu``,
e.g. ``OLD/embedding_bag.cu``) beside the kernels and compares the two
builds in turns: the olmoe decode and prefill profiles and the profiled
CTR window (this, previous, this) and the timed kernels (previous, this,
this, previous).

It then prints one ``{"kernels": [...]}`` JSON line and, last, the
``{"ok": true, "device": {...}}`` line.  Imports neither jax nor the JAX
package.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
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
TF32X3_FLOPS = 495e12 / 3        # f32-accurate products as 3 TF32 products
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


#: phase 16's decode shapes (4 slots, page size 16): (arch, KV, G, hd,
#: pages a slot, window, softcap, q_pos), each arch in its dtype
#: (ARCH_RUNS)
ARCH_DECODE = (
    ("chatglm3-6b", 2, 16, 128, 35, None, None, [76, 200, 350, 551]),
    ("gemma2-2b", 4, 2, 256, 291, 4096, 50.0, [4639, 551, 300, 76]),
    ("internlm2-20b", 8, 6, 128, 35, None, None, [76, 200, 350, 551]),
    ("qwen3-moe-30b-a3b", 4, 8, 128, 35, None, None, [76, 200, 350, 551]),
    ("jamba-v0.1-52b", 8, 4, 128, 35, None, None, [76, 200, 350, 551]),
    ("llama-3.2-vision-11b", 8, 4, 128, 35, None, None, [76, 200, 350, 551]),
    ("whisper-large-v3", 20, 1, 64, 35, None, None, [76, 200, 350, 551]),
)


#: phases 16's and 17's dtypes: float32 where the weights fit the card
#: beside the run (chatglm3-6b 25 GB, gemma2-2b 10.5 GB, rwkv6-7b 30.2 GB,
#: llama-3.2-vision-11b 39.1 GB, whisper-large-v3 8.0 GB), bfloat16 where
#: they do not (internlm2-20b 80 GB and qwen3-moe-30b-a3b 122 GB in
#: float32; jamba-v0.1-52b 103 GB even in bfloat16, served at 16 layers)
ARCH_DTYPE = {"chatglm3-6b": "float32", "gemma2-2b": "float32",
              "internlm2-20b": "bfloat16", "qwen3-moe-30b-a3b": "bfloat16",
              "rwkv6-7b": "float32", "jamba-v0.1-52b": "bfloat16",
              "llama-3.2-vision-11b": "float32",
              "whisper-large-v3": "float32"}


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
    # the decode steps of phases 16's and 17's serve runs: 4 slots,
    # 35-page tables (gemma2: 291 pages, one sequence past its window of
    # 4,096; whisper: G 1)
    for label, KV, G, hd, P, w, sc, pos in ARCH_DECODE:
        cases.append((f"{label} serve B4 KV{KV} G{G} hd{hd}", 4, KV, G, hd,
                      16, P, w, sc, pos, ()))
    # the split over KV pages (B2 KV2 on P 40 or 37: 10 splits of 4 pages;
    # SPLIT_CASES says what each must show)
    cases.append(("splits: sequences across split boundaries", 2, 2, 4, 64,
                  16, 40, None, None, [639, 300], ()))
    cases.append(("splits: q_pos ends in the first split", 2, 2, 4, 64, 16,
                  40, None, None, [20, 63], ()))
    cases.append(("splits: window starts mid-split", 2, 2, 4, 64, 16, 40, 90,
                  None, [500, 300], ()))
    cases.append(("splits: P 37 does not divide into the splits", 2, 2, 4,
                  64, 16, 37, 50, 30.0, [591, 100], ()))
    return cases


def check_split_cases(torch, pk):
    """Each ``splits:`` case of kernel_cases() shows what its label says,
    under the split count the wrapper picks on this card."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for label, B, KV, G, hd, ps, P, w, sc, pos, _ in kernel_cases():
        if not label.startswith("splits:"):
            continue
        splits, pps = pk.decode_splits(B, KV, P, sms)
        check(splits > 1, f"{label}: one split on {sms} SMs")
        last = [p // ps for p in pos]                  # last live page
        first = [max(p - w + 1, 0) // ps if w else 0 for p in pos]
        if "across" in label:
            ok = all(lp // pps > 0 for lp in last)
        elif "first split" in label:
            ok = all(lp < pps for lp in last)
        elif "window" in label:
            ok = all(fp % pps != 0 for fp in first)
        else:
            ok = P % pps != 0
        check(ok, f"{label}: not shown with {splits} splits of {pps} pages "
              f"(q_pos {pos}, window {w})")
        say("kernels", f"{label}: {splits} splits of {pps} pages")


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
            again = pk.paged_decode_cuda(q, kp, vp, table, qp, window=w,
                                         softcap=sc)
            want = pk.paged_decode_gather(q, kp, vp, table, qp, window=w,
                                          softcap=sc)
            torch.cuda.synchronize()
            check(torch.equal(got, again),
                  f"{label} {dname}: two calls are not bit-equal")
            check(bool(torch.isfinite(got.float()).all()),
                  f"{label} {dname}: non-finite output")
            err = (got.float() - want.float()).abs().max().item()
            worst[dname] = max(worst[dname], err)
            check(err <= TOL[dname],
                  f"{label} {dname}: max|kernel-gather| {err:.3e} > "
                  f"{TOL[dname]:.0e}")
        say("kernels", f"paged_decode ok: {label}")
    say("kernels", f"paged_decode max|err| float32 {worst['float32']:.3e} "
        f"(atol 2e-5), bfloat16 {worst['bfloat16']:.3e} (atol 2e-2); every "
        "case bit-equal over two calls")
    check_split_cases(torch, pk)
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
#: (tests/test_kernels.py) and olmoe-1b-7b's, qwen3-moe-30b-a3b's and
#: jamba-v0.1-52b's decode and prefill shapes
MOE_CASES = [
    ("test G2 S24 D16 E4 K2 cf1.25", 2, 24, 16, 4, 2, 1.25),
    ("test G1 S64 D32 E8 K2 cf1.0", 1, 64, 32, 8, 2, 1.0),
    ("test G2 S32 D16 E4 K1 cf0.25 (drops)", 2, 32, 16, 4, 1, 0.25),
    ("test G1 S8 D16 E4 K4 cf8 (top_k = E)", 1, 8, 16, 4, 4, 8.0),
    ("olmoe decode G4 S1 D2048 E64 K8 C8", 4, 1, 2048, 64, 8, 1.25),
    ("olmoe prefill G1 S512 D2048 E64 K8 C80", 1, 512, 2048, 64, 8, 1.25),
    ("qwen3 decode G4 S1 D2048 E128 K8 C8", 4, 1, 2048, 128, 8, 1.25),
    ("qwen3 prefill G1 S512 D2048 E128 K8 C40", 1, 512, 2048, 128, 8, 1.25),
    ("jamba decode G4 S1 D4096 E16 K2 C8", 4, 1, 4096, 16, 2, 1.25),
    ("jamba prefill G1 S512 D4096 E16 K2 C80", 1, 512, 4096, 16, 2, 1.25),
]


def same_bits(torch, a, b) -> bool:
    """a and b hold the same bits (signed zeros and NaNs included)."""
    as_int = {torch.float32: torch.int32, torch.bfloat16: torch.int16}
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        a.view(as_int[a.dtype]), b.view(as_int[b.dtype]))


def phase_moe_kernels(torch, mk):
    """Both MoE kernels against their plain versions on MOE_CASES and with
    out-of-range indices: within MOE_TOL of ``dispatch_slot`` /
    ``combine_slot``, and bit for bit equal to the plain versions with the
    kernels' rounding (dispatch formed in float32 and cast once, which in
    float32 is ``dispatch_slot`` itself; ``combine_slot_ordered``), for the
    contiguous and the strided slab, and to their own second launch."""
    from repro_torch.nn import moe as nn_moe

    worst = {k: {"float32": 0.0, "bfloat16": 0.0}
             for k in ("moe_dispatch", "moe_combine")}
    n_exact = 0

    def held(label, dname, got, want):
        """``label`` starts with the kernel's name: dispatch or combine."""
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        kname = "moe_" + label.split()[0]
        worst[kname][dname] = max(worst[kname][dname], err)
        check(err <= MOE_TOL[dname], f"{label} {dname}: max|kernel-slot| "
              f"{err:.3e} > {MOE_TOL[dname]:.0e}")

    def exact(label, dname, got, want):
        nonlocal n_exact
        torch.cuda.synchronize()
        check(same_bits(torch, got, want), f"{label} {dname}: not bit-equal")
        n_exact += 1

    def both(label, dname, x, src, sw, eid, pos, w):
        """Every check of one case; returns the slab."""
        dt = x.dtype
        buf = mk.moe_dispatch_cuda(x, src, sw)
        held(f"dispatch {label}", dname, buf, mk.dispatch_slot(x, src, sw))
        exact(f"dispatch {label} vs f32-formed dispatch_slot", dname, buf,
              mk.dispatch_slot(x.float(), src, sw).to(dt))
        exact(f"dispatch {label} on repeat", dname,
              mk.moe_dispatch_cuda(x, src, sw), buf)
        # the slab as the expert product leaves it: a (G, E, C, D) view of
        # (E, G, C, D) storage, read through its strides
        strided = buf.transpose(0, 1).contiguous().transpose(0, 1)
        want = mk.combine_slot_ordered(buf, eid, pos, w)
        for slab, how in ((buf, ""), (strided, " strided slab")):
            y = mk.moe_combine_cuda(slab, eid, pos, w)
            held(f"combine {label}{how}", dname, y,
                 mk.combine_slot(buf, eid, pos, w))
            exact(f"combine {label}{how} vs combine_slot_ordered", dname, y,
                  want)
            exact(f"combine {label}{how} on repeat", dname,
                  mk.moe_combine_cuda(slab, eid, pos, w), y)
        return buf

    for label, G, S, D, E, K, cf in MOE_CASES:
        for dname in ("float32", "bfloat16"):
            x, src, sw, eid, pos, w, C = moe_inputs(
                torch, nn_moe, mk, G=G, S=S, D=D, E=E, K=K, cf=cf,
                dtype=getattr(torch, dname), seed=len(label))
            buf = both(label, dname, x, src, sw, eid, pos, w)
            check(buf.shape == (G, E, C, D), f"{label}: slab {buf.shape}")
            check(bool(torch.isfinite(buf.float()).all()),
                  f"{label} {dname}: non-finite slab")
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
        eid = torch.randint(-2, E + 3, (G, S, K), generator=g,
                            device="cuda", dtype=torch.int32)
        pos = torch.randint(-2, C + 5, (G, S, K), generator=g,
                            device="cuda", dtype=torch.int32)
        w = torch.rand((G, S, K), generator=g, device="cuda")
        w = w / w.sum(-1, keepdim=True)
        both("clamp", dname, x, src, sw, eid, pos, w)
    say("kernels", "moe_dispatch + moe_combine ok: out-of-range src/eid/pos "
        "clamped")
    for kname, err in worst.items():
        say("kernels", f"{kname} max|err| float32 {err['float32']:.3e} "
            f"(atol 1e-5), bfloat16 {err['bfloat16']:.3e} (atol 5e-2)")
    say("kernels", f"MoE bit-exact checks: {n_exact} passed (float32 and "
        "bfloat16: dispatch = dispatch_slot formed in float32, combine = "
        "combine_slot_ordered, contiguous and strided slab, each on repeat)")
    return worst


#: (label, G, S, E, dtype name): the MoE Functions' backward at
#: olmoe-1b-7b's 512-token prefill (float32 and bfloat16), a slice of its
#: bfloat16 training batch (2 of 8 sequences of 2,048 tokens) and
#: qwen3-moe-30b-a3b's prefill in bfloat16; D 2048, K 8, cf 1.25
MOE_BWD_CASES = (("olmoe prefill G1 S512 E64", 1, 512, 64, "float32"),
                 ("olmoe prefill G1 S512 E64", 1, 512, 64, "bfloat16"),
                 ("olmoe train G2 S2048 E64", 2, 2048, 64, "bfloat16"),
                 ("qwen3 prefill G1 S512 E128", 1, 512, 128, "bfloat16"))


def bf16_ulps(torch, t, n: int = 4) -> float:
    """``n`` bfloat16 ulps at the largest |value| of ``t`` (an ulp is
    2^-7 of the power of two at or below a value)."""
    top = t.float().abs().max().item()
    return n * 2.0 ** (math.floor(math.log2(top)) - 7) if top > 0 else 0.0


def phase_moe_backward(torch, mk):
    """The MoE autograd Functions (``kernels.ops.moe_dispatch`` /
    ``moe_combine`` with ``impl="cuda"``) against autograd of the slot
    versions on MOE_BWD_CASES: dx through dispatch's backward (the
    combine kernel), dbuf through combine's backward (the dispatch
    kernel) and dw (a gather-dot over D = 2048).  float32: dx and dbuf at
    atol 1e-5, dw at 1e-4 (a sum in another order).  bfloat16: each
    within 4 bfloat16 ulps of its largest |value| (the kernels form
    products in float32 and round once; the slot versions multiply and
    accumulate in bfloat16, over up to K = 8 terms for dx and D terms
    for dw).  dw of a dropped pair is 0 (the reference's backward masks
    it by keep)."""
    from repro_torch.kernels import ops
    from repro_torch.nn import moe as nn_moe

    D, K = 2048, 8
    out = {}
    for label, G, S, E, dname in MOE_BWD_CASES:
        dt = getattr(torch, dname)
        g = torch.Generator(device="cuda")
        g.manual_seed(21)
        x = torch.randn((G, S, D), generator=g, device="cuda")
        router = torch.randn((D, E), generator=g, device="cuda") / D ** 0.5
        C = nn_moe.moe_capacity(S, E, K, 1.25)
        _, gate, eid, pos, keep = nn_moe.moe_route(router, x, top_k=K,
                                                   capacity=C)
        wtok = keep.to(torch.float32)           # as nn.moe passes them
        w = (gate.reshape(G, S * K) * keep).reshape(G, S, K).to(dt)
        safe = torch.where(keep, pos, 0).reshape(G, S, K)
        g_buf = torch.randn((G, E, C, D), generator=g, device="cuda").to(dt)
        g_y = torch.randn((G, S, D), generator=g, device="cuda").to(dt)
        x = x.to(dt)

        def grads(impl):
            xi = x.clone().requires_grad_(True)
            buf = ops.moe_dispatch(xi, eid, pos, wtok, num_experts=E,
                                   capacity=C, top_k=K, impl=impl)
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
            check(a.dtype == dt and bool(torch.isfinite(a.float()).all()),
                  f"MoE backward {label} {dname} {name}: dtype {a.dtype} or "
                  "non-finite")
            if dname == "bfloat16":
                atol = bf16_ulps(torch, b)
            errs[name] = (a.float() - b.float()).abs().max().item()
            check(errs[name] <= atol, f"MoE backward {label} {dname} {name}:"
                  f" max|Function - slot autograd| {errs[name]:.3e} > "
                  f"{atol:.3e}")
            errs[name + "_tol"] = atol
        say("kernels", f"MoE backward at {label} K{K} C{C} D{D} {dname}: "
            f"max|err| dx {errs['dx']:.3e}, dbuf {errs['dbuf']:.3e}, dw "
            f"{errs['dw']:.3e} (atol {errs['dx_tol']:.3e} / "
            f"{errs['dbuf_tol']:.3e} / {errs['dw_tol']:.3e}; dispatch's "
            "backward is the combine kernel and back)")
        out[f"{label} {dname}"] = errs
        del x, g_buf, g_y, got, want
    torch.cuda.empty_cache()
    return out


#: (label, B, H, Sq, Sk, hd, causal, window, softcap): the reference sweep
#: (tests/test_kernels.py: shapes, windows 32/100/128, softcap 50, non
#: causal, cross lengths), partial tiles, windows that leave rows with no
#: key, the shapes train() feeds the kernels (llama3.2-1b's microbatch
#: of 4, olmoe-1b-7b's heads), phase 16's (a sequence of olmoe-1b-7b's
#: bfloat16 training, gemma2-2b's long prefill past its window) and phase
#: 17's (whisper-large-v3's encoder over 1,500 frames, its and
#: llama-3.2-vision-11b's cross-attention over 1,500 / 1,601 keys)
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
    ("llama reduced B2 H8 S128 hd32", 2, 8, 128, 128, 32, True, None, None),
    ("causal S200 hd32 window 16 softcap 30", 1, 2, 200, 200, 32, True, 16,
     30.0),
    ("olmoe / chatglm3 train B1 H16 S2048 hd128", 1, 16, 2048, 2048, 128,
     True, None, None),
    ("gemma2 prefill B1 H8 S4608 hd256 window 4096 softcap 50", 1, 8, 4608,
     4608, 256, True, 4096, 50.0),
    ("whisper encoder B4 H20 S1500 hd64 non-causal", 4, 20, 1500, 1500, 64,
     False, None, None),
    ("whisper cross B4 H20 Sq512 Sk1500 hd64", 4, 20, 512, 1500, 64, False,
     None, None),
    ("vision cross B4 H32 Sq512 Sk1601 hd128", 4, 32, 512, 1601, 128, False,
     None, None),
]

#: keys a forward block takes per step (``Fwd<T, HD>::COLS`` in
#: ``csrc/flash_attention.cu``): where the kernel's online softmax rescales
FWD_KEY_TILE = {32: 64, 64: 64, 128: 64, 256: 32}


def plain_logits(torch, fk, q, k, causal, window, softcap):
    """The float32 logits as ``flash_attention_ref`` forms them, masked
    logits -1e30, with tanh(u / cap) (None without a soft cap) and the
    mask of visible pairs."""
    Sq, Sk, hd = q.shape[2], k.shape[2], q.shape[3]
    s = q.float() @ k.float().transpose(-1, -2) * hd ** -0.5
    th = None
    if softcap is not None:
        th = torch.tanh(s / softcap)
        s = softcap * th
    qpos = torch.arange(Sq, device=q.device)[:, None]
    kpos = torch.arange(Sk, device=q.device)[None, :]
    ok = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        ok = ok & (qpos >= kpos)
    if window is not None:
        ok = ok & ((qpos - kpos) < window)
    return torch.where(ok, s, fk.NEG_INF), th, ok


def flash_fwd_bf16_rounded(torch, fk, q, k, v, causal, window, softcap):
    """``flash_attention_ref`` written out in float32 with the roundings the
    bfloat16 forward kernel makes: the online softmax over key tiles of the
    kernel's width, in order, each tile's weights p = exp(s - running max)
    rounded to bfloat16 for P·V and summed unrounded into the denominator.
    Returns o in float32, before the output's own bfloat16 rounding."""
    s, _, _ = plain_logits(torch, fk, q, k, causal, window, softcap)
    vf = v.float()
    m = torch.full(s.shape[:-1] + (1,), -math.inf, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros(q.shape, device=q.device)
    cols = FWD_KEY_TILE[q.shape[3]]
    for c0 in range(0, k.shape[2], cols):
        st = s[..., c0:c0 + cols]
        m_new = torch.maximum(m, st.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(st - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = (acc * alpha
               + p.to(torch.bfloat16).float() @ vf[..., c0:c0 + cols, :])
        m = m_new
    return acc / l


def flash_bwd_bf16_rounded(torch, fk, q, k, v, o, do, causal, window,
                           softcap):
    """Autograd's backward of ``flash_attention_ref`` written out in float32
    with the roundings the bfloat16 kernel makes: D = sum(dO * o) from the
    bfloat16 output, and p and dS rounded to bfloat16 before the products
    they feed (dV = pᵀ dO, dK = dSᵀ q, dQ = dS k).  Returns dq, dk, dv."""
    def bf(t):
        return t.to(torch.bfloat16).float()

    qf, kf, vf, dof = (t.float() for t in (q, k, v, do))
    scale = q.shape[3] ** -0.5
    s, th, ok = plain_logits(torch, fk, q, k, causal, window, softcap)
    p = torch.softmax(s, dim=-1)
    ds = p * (dof @ vf.transpose(-1, -2)
              - (dof * o.float()).sum(-1, keepdim=True))
    if softcap is not None:
        ds = ds * (1 - th * th)
    p, ds = bf(p), bf(torch.where(ok, ds, 0.0))
    return (ds @ kf * scale, ds.transpose(-1, -2) @ qf * scale,
            p.transpose(-1, -2) @ dof)


def worst_gap(torch, a, b):
    """The largest |a - b|, |b| there, and that gap in bfloat16 ulps of b
    (|b| in [2^(e-1), 2^e) has ulp 2^(e-8))."""
    gap = (a - b).abs().flatten()
    i = int(gap.argmax())
    ref = b.flatten()[i]
    ulp = 2.0 ** (int(torch.frexp(ref).exponent) - 8)
    return gap[i].item(), ref.abs().item(), gap[i].item() / ulp


def head_ulp_gap(torch, a, r):
    """The largest |a - r|, in bfloat16 ulps of the largest |r| of the same
    (batch, head) matrix, with that gap and that largest |r|.  An element
    is a sum whose terms have its head's scale: one that cancels to near 0
    (or to exactly 0, as row 0's dQ does in causal attention) is held to
    its head's ulp, not to its own; where one bfloat16 rounding of a term
    fell differently it is a few ulps of the term away, thousands of ulps
    of such an element."""
    top = r.abs().amax((-2, -1), keepdim=True).expand_as(r)
    ulp = torch.exp2(torch.frexp(top).exponent.float() - 8)
    ratio = ((a - r).abs() / ulp).flatten()
    i = int(ratio.argmax())
    return (ratio[i].item(), (a - r).abs().flatten()[i].item(),
            top.flatten()[i].item())


def phase_flash_kernels(torch, fk):
    """The flash forward against ``flash_attention_ref`` and the backward
    (dK/dV pass, then dQ pass) against autograd of it, on the same inputs,
    every entry point bit-equal over two runs.  bfloat16 is also held
    within 1 ulp of the plain versions that make the kernels' roundings
    (``flash_fwd_bf16_rounded``, ``flash_bwd_bf16_rounded``), each element
    in ulps of its head's largest value (``head_ulp_gap``); the worst gap
    in ulps of the element itself (``worst_gap``) is printed beside it.
    Returns each entry point's worst error per dtype."""
    worst = {n: {"float32": 0.0, "bfloat16": 0.0}
             for n in ("flash_fwd", "flash_bwd_dkdv", "flash_bwd_dq")}
    #: bfloat16: (gap, |ref|, ulps, case) of the kernel and of the rounded
    #: plain backward against autograd, and the worst kernel-vs-rounded gap;
    #: and (head ulps, gap, head max, case) of kernel vs rounded plain
    bf16_gap = {"backward kernel vs autograd": (0.0,),
                "backward rounded plain vs autograd": (0.0,),
                "backward kernel vs rounded plain": (0.0,),
                "forward kernel vs rounded plain": (0.0,)}
    head_gap = {"forward": (0.0,), "backward": (0.0,)}

    def rounded_check(direction, label, name, a, r):
        gap = head_ulp_gap(torch, a, r) + (f"{label} {name}",)
        check(gap[0] <= 1.0, f"flash {label} bfloat16: {direction} {name} is "
              f"{gap[0]:.2f} ulp of its head ({gap[1]:.3e} at head max "
              f"{gap[2]:.3e}) from the rounded plain version (> 1 ulp)")
        if gap[0] > head_gap[direction][0]:
            head_gap[direction] = gap

    def track(key, x, y, where):
        gap = worst_gap(torch, x, y) + (where,)
        if gap[0] > bf16_gap[key][0]:
            bf16_gap[key] = gap

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
            o2, lse2 = fk.flash_fwd_cuda(q, k, v, **kw)
            want = fk.flash_attention_ref(q, k, v, **kw)
            torch.cuda.synchronize()
            check(torch.equal(o, o2) and torch.equal(lse, lse2),
                  f"flash {label} {dname}: two forward runs are not "
                  "bit-equal")
            del o2, lse2
            check(bool(torch.isfinite(o.float()).all()),
                  f"flash {label} {dname}: non-finite output")
            err = (o.float() - want.float()).abs().max().item()
            worst["flash_fwd"][dname] = max(worst["flash_fwd"][dname], err)
            check(err <= FLASH_TOL[dname], f"flash {label} {dname}: "
                  f"max|kernel-plain| {err:.3e} > {FLASH_TOL[dname]:.0e}")
            if dname == "bfloat16":
                r = flash_fwd_bf16_rounded(torch, fk, q, k, v, causal,
                                           window, cap)
                r = r.to(torch.bfloat16).float()
                rounded_check("forward", label, "o", o.float(), r)
                track("forward kernel vs rounded plain", o.float(), r,
                      f"{label} o")
                del r
            dk, dv, delta = fk.flash_bwd_dkdv_cuda(q, k, v, o, lse, do, **kw)
            dq = fk.flash_bwd_dq_cuda(q, k, v, do, lse, delta, **kw)
            dk2, dv2, delta2 = fk.flash_bwd_dkdv_cuda(q, k, v, o, lse, do,
                                                      **kw)
            dq2 = fk.flash_bwd_dq_cuda(q, k, v, do, lse, delta2, **kw)
            check(all(torch.equal(a, b) for a, b in (
                (dk, dk2), (dv, dv2), (delta, delta2), (dq, dq2))),
                f"flash {label} {dname}: two backward runs are not "
                "bit-equal")
            del dk2, dv2, delta2, dq2
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
                err = (a - b).abs().max().item()
                worst[entry][dname] = max(worst[entry][dname], err)
                # 3xTF32 keeps float32 accuracy: the forward's bound holds
                check(dname != "float32" or err <= FLASH_TOL[dname],
                      f"flash {label} float32: {name} max|err| {err:.3e} > "
                      f"{FLASH_TOL[dname]:.0e}")
            if dname == "bfloat16":
                rounded = flash_bwd_bf16_rounded(torch, fk, q, k, v, o, do,
                                                 causal, window, cap)
                for name, a, r, b in zip(("dq", "dk", "dv"), (dq, dk, dv),
                                         rounded, ref):
                    a, b = a.float(), b.float()
                    r = r.to(torch.bfloat16).float()
                    rounded_check("backward", label, name, a, r)
                    where = f"{label} {name}"
                    track("backward kernel vs autograd", a, b, where)
                    track("backward rounded plain vs autograd", r, b, where)
                    track("backward kernel vs rounded plain", a, r, where)
                del rounded
            del ref, qkv
        say("kernels", f"flash forward + backward ok (each bit-equal over "
            f"two runs): {label}")
    for name, err in worst.items():
        say("kernels", f"{name} max|err| float32 {err['float32']:.3e}, "
            f"bfloat16 {err['bfloat16']:.3e}")
    for key, (gap, ref, ulps, where) in bf16_gap.items():
        say("kernels", f"flash bfloat16 worst gap, {key}: {gap:.4e} at |ref| "
            f"{ref:.4e} = {ulps:.2f} ulp of the element ({where})")
    for key, (ulps, gap, top, where) in head_gap.items():
        say("kernels", f"flash bfloat16 {key}, kernel vs rounded plain: at "
            f"most {ulps:.2f} ulp of the head's largest value ({gap:.4e} at "
            f"head max {top:.4e}, {where}; checked <= 1)")
    return worst


#: (label, N, bag, V, dim): the reference sweep (tests/test_kernels.py),
#: the CTR path's pulls (the hot-cache lookup of a whole batch, and the
#: batch's 26 slots pooled from the full table), the timed pooled shape,
#: bags longer than one of the kernel's stages (64 rows), bags too many to
#: be staged at once (streamed), a row width off the 16-byte vectors and
#: ragged widths
BAG_CASES = [
    ("test N8 bag4 V100 dim128", 8, 4, 100, 128),
    ("test N16 bag1 V50 dim128", 16, 1, 50, 128),
    ("test N4 bag16 V1000 dim256", 4, 16, 1000, 256),
    ("ctr hot-cache lookup N6656 bag1 V4096 dim16", 6656, 1, 4096, 16),
    ("ctr pooled N256 bag26 V200000 dim16", 256, 26, 200_000, 16),
    ("bench pooled N256 bag26 V100000 dim128", 256, 26, 100_000, 128),
    ("ring N256 bag70 V100000 dim128", 256, 70, 100_000, 128),
    ("ring N256 bag300 V200000 dim16", 256, 300, 200_000, 16),
    ("streamed N4096 bag300 V100000 dim128", 4096, 300, 100_000, 128),
    ("streamed N8192 bag26 V200000 dim128", 8192, 26, 200_000, 128),
    ("odd width N256 bag26 V100000 dim130", 256, 26, 100_000, 130),
    ("ragged N7 bag3 V50 dim5", 7, 3, 50, 5),
    ("ragged N33 bag5 V64 dim12", 33, 5, 64, 12),
]


def bag_tol(dname: str, bag: int):
    """(atol, rtol) of the kernel against ``embedding_bag_ref``: BAG_TOL
    up to the reference test's bags; past them a float32 sum in another
    order drifts with the bag's length, and a bfloat16 output may then
    round to the other neighbour (one ulp, at most 2^-7 of |value|)."""
    if bag <= 26:
        return BAG_TOL[dname], 0.0
    if dname == "float32":
        return BAG_TOL[dname] * bag / 26, 0.0
    return BAG_TOL[dname], 2.0 ** -7


def phase_bag_kernels(torch, bk):
    """embedding_bag bit for bit equal to ``embedding_bag_ordered`` (the
    sum in the kernel's order) and to its own second launch, in float32
    and bfloat16, and within :func:`bag_tol` of the plain version: on
    BAG_CASES, on a table view offset by one element (the fallback),
    duplicate ids and out-of-range ids (negative, past the table, past
    int32 in int64, clamped); a bag of one bit-equal to a gather."""
    worst = {"float32": 0.0, "bfloat16": 0.0}
    n_exact = 0

    def held(label, dname, ids, table):
        got = bk.embedding_bag_cuda(ids, table)
        want = bk.embedding_bag_ref(ids, table)
        torch.cuda.synchronize()
        check(got.dtype == table.dtype and bool(
            torch.isfinite(got.float()).all()), f"{label} {dname}: output")
        err = (got.float() - want.float()).abs()
        atol, rtol = bag_tol(dname, ids.shape[1])
        worst[dname] = max(worst[dname], err.max().item())
        over = (err - atol - rtol * want.float().abs()).max().item()
        check(over <= 0, f"{label} {dname}: max|kernel-plain| "
              f"{err.max().item():.3e} past atol {atol:.1e} rtol {rtol:.1e}")
        exact(f"{label} vs embedding_bag_ordered", dname, got,
              bk.embedding_bag_ordered(ids, table))
        exact(f"{label} on repeat", dname, bk.embedding_bag_cuda(ids, table),
              got)
        return got

    def exact(label, dname, got, want):
        nonlocal n_exact
        torch.cuda.synchronize()
        check(same_bits(torch, got, want), f"{label} {dname}: not bit-equal")
        n_exact += 1

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
            # the same values in a view offset by one element: the table
            # is no longer 16-byte aligned, so the fallback runs
            base = torch.empty(V * dim + 1, dtype=dt, device="cuda")
            shifted = base[1:].view(V, dim).copy_(table)
            got = held(label + " (table offset by one element)", dname, ids,
                       shifted)
            if bag == 1:
                check(torch.equal(got, table[ids[:, 0].long()]),
                      f"{label} {dname}: offset table: a bag of one is not "
                      "bit-equal to a gather")
            del table, base, shifted
        say("kernels", f"embedding_bag ok: {label}, aligned and offset by "
            "one element")
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
        f"(atol 1e-5, scaled past bag 26), bfloat16 {worst['bfloat16']:.3e} "
        f"(atol 5e-2; past bag 26 plus 2^-7 of |value|); {n_exact} "
        "bit-exact checks passed (embedding_bag_ordered, and on repeat)")
    torch.cuda.empty_cache()
    return worst


# --------------------------------------------------------------------------
# phase 4: the CLIs with their defaults
# --------------------------------------------------------------------------

#: (label, module, arguments): each CLI as a user starts it, with its
#: defaults: reduced llama3.2-1b (head dim 32) on the card
CLI_RUNS = (("serve", "repro_torch.launch.serve", []),
            ("serve --continuous", "repro_torch.launch.serve",
             ["--continuous"]),
            ("serve --continuous --replan", "repro_torch.launch.serve",
             ["--continuous", "--replan"]),
            ("train", "repro_torch.launch.train", []))


def cli_json(text):
    """The JSON summary a CLI prints last (the train CLI logs steps first)."""
    return json.loads(text[text.index("{"):])


def check_cli_summary(label, out):
    """What each CLI's JSON summary must show: the card, finite results,
    every request served or every step taken."""
    if label == "train":
        check(out["devices"] == ["cuda:0"] and out["steps"] == 50
              and all(math.isfinite(x) for x in out["losses"]),
              f"{label} CLI: steps {out['steps']}, devices {out['devices']}"
              f", losses {out['first_loss']} .. {out['last_loss']}")
        return f"50 steps, loss {out['first_loss']:.4f} -> {out['last_loss']:.4f}"
    check(out["device"].startswith("cuda") and out["tokens_in_vocab"],
          f"{label} CLI: device {out['device']}, tokens in vocab "
          f"{out['tokens_in_vocab']}")
    if label == "serve":
        check(out["generated_shape"] == [4, 16], f"{label} CLI: generated "
              f"{out['generated_shape']}")
        return f"4 x 16 tokens, {out['decode_tok_per_s']:.1f} decode tok/s"
    check(set(out["outcomes"]) == {"completed"} and out["pool_conserved"],
          f"{label} CLI: outcomes {out['outcome_counts']}, pool conserved "
          f"{out['pool_conserved']}")
    what = (f"{out['requests']} requests completed, {out['prefills']} "
            f"prefills, {out['decode_steps']} decode steps")
    if "--replan" in label:
        rep = out.get("replan", {})
        check("errors" not in rep and "admission" in rep
              and math.isfinite(rep["incumbent"]["cost"]),
              f"{label} CLI: replan report {rep}")
        what += (f"; replan incumbent cost {rep['incumbent']['cost']:.6g}, "
                 f"{rep['windows']} windows")
    return what


def phase_cli(torch, counters):
    """``python -m repro_torch.launch.serve``, ``... serve --continuous``
    and ``python -m repro_torch.launch.train`` with their defaults as
    subprocesses on the card (exit code 0 and the JSON summary each
    prints), then the same three through their ``main`` in this process
    with every launch count set to 0 just before each and read just after:
    every prefill runs the flash forward once a layer, a train step twice
    a layer (forward and remat recompute) and each backward pass once."""
    import contextlib
    import io
    import os

    from repro_torch.configs import get_config
    from repro_torch.launch import serve as serve_cli
    from repro_torch.launch import train as train_cli

    layers = get_config("llama3.2-1b", reduced=True).num_layers
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(SRC)] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    by_run = {}
    for label, module, args in CLI_RUNS:
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", module, *args], cwd=ROOT,
                              env=env, capture_output=True, text=True,
                              timeout=300)
        check(proc.returncode == 0, f"{label} CLI exited {proc.returncode}:"
              f"\n{proc.stderr[-3000:]}")
        what = check_cli_summary(label, cli_json(proc.stdout))
        say("cli", f"python -m {module} {' '.join(args)}: exit 0 in "
            f"{time.perf_counter() - t0:.1f} s; {what}")

        main = (train_cli if label == "train" else serve_cli).main
        for fn in counters.values():
            fn.launches = 0
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            main(list(args))
        launches = {name: fn.launches for name, fn in counters.items()}
        out = cli_json(buf.getvalue())
        check_cli_summary(label, out)
        continuous = {"flash_fwd": layers * out.get("prefills", 0),
                      "paged_decode": layers * out.get("decode_steps", 0)}
        want = {  # serve prefills its batch once and decodes densely
            "serve": {"flash_fwd": layers},
            "serve --continuous": continuous,
            "serve --continuous --replan": continuous,
            "train": {"flash_fwd": 2 * layers * 50,
                      "flash_bwd_dkdv": layers * 50,
                      "flash_bwd_dq": layers * 50}}[label]
        check(all(launches[k] == want.get(k, 0) for k in counters),
              f"{label} CLI in-process: launches {launches}, expected {want}")
        say("cli", f"{label} in-process, launches {launches}")
        by_run[f"cli {label}"] = launches
    return by_run


# --------------------------------------------------------------------------
# phases 5 and 7: the main paths
# --------------------------------------------------------------------------

REQUESTS = [(64, 32), (512, 32), (128, 32), (300, 32), (96, 32), (448, 32),
            (200, 32), (256, 32)]


def counted_serve(torch, counters, arch, params, *, requests=REQUESTS,
                  compute_dtype=None, phase="serve"):
    """One ``serve_continuous`` of ``requests`` at full width with every
    launch count set to 0 just before it and read just after; checks the
    outcomes and prints the rates.  ``arch``: an arch id or an
    ``ArchConfig`` (cut in depth)."""
    from repro_torch.launch.serve import serve_continuous

    kw = dict(reduced=False, device="cuda", requests=requests, slots=4,
              params=params, compute_dtype=compute_dtype or torch.float32)
    cfg, arch = arch, (arch if isinstance(arch, str) else arch.name)
    # the same mix once first: CUDA start-up and the first use of every
    # matmul shape stay out of the measured run
    t0 = time.perf_counter()
    serve_continuous(cfg, **kw)
    say(phase, f"{arch}: warm-up run of the same mix "
        f"{time.perf_counter() - t0:.2f} s")
    for fn in counters.values():
        fn.launches = 0
    out = serve_continuous(cfg, **kw)
    launches = {name: fn.launches for name, fn in counters.items()}
    check(out["outcomes"] == ["completed"] * len(requests),
          f"{arch} outcomes {out['outcomes']}")
    check(out["generated"] == [g for _, g in requests],
          f"{arch} generated {out['generated']}")
    check(out["tokens_in_vocab"], f"{arch}: tokens outside the vocabulary")
    check(out["pool_conserved"], f"{arch}: page pool not conserved")
    check(out["decode_steps"] > 0, f"{arch}: no decode step")
    ttft = [t for t in out["ttft_s"] if t is not None]
    toks = sum(out["generated"])
    out["decode_tok_per_s_in_chunks"] = toks / out["decode_s"]
    say(phase, f"{arch}: {len(requests)} requests completed, {toks} "
        f"tokens, {out['decode_steps']} decode steps, {out['prefills']} "
        f"prefills; launches {launches}")
    say(phase, f"{arch}: decode tok/s {toks / out['decode_s']:.1f} "
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


def check_prefill_flash(launches, layers, prefills, arch, phase="serve"):
    """Every causal prefill runs the flash forward once per layer; serving
    runs no backward."""
    check(launches["flash_fwd"] == layers * prefills,
          f"{arch}: flash_fwd launches {launches['flash_fwd']} != {layers} x "
          f"{prefills} prefills")
    check(launches["flash_bwd_dkdv"] == launches["flash_bwd_dq"] == 0,
          f"{arch}: serving launched a flash backward")
    say(phase, f"{arch}: flash_fwd launches = {layers} x {prefills} "
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
    for name in ("moe_dispatch", "moe_combine", "moe_positions"):
        check(launches[name] == layers * (steps + pre),
              f"{name} launches {launches[name]} != {layers} x ({steps} "
              f"decode steps + {pre} prefills)")
    check(launches["paged_decode"] == layers * steps,
          f"paged_decode launches {launches['paged_decode']} != {layers} x "
          f"{steps} steps")
    check_prefill_flash(launches, layers, pre, "olmoe-1b-7b")
    say("moe", f"launches: moe_dispatch = moe_combine = moe_positions = "
        f"{layers} x ({steps} "
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
              for k in ("paged_decode", "moe_dispatch", "moe_combine",
                        "moe_positions")),
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
# phase 6: where a decode step's time goes
# --------------------------------------------------------------------------

#: kernel-name fragments of the profile's device-time split, checked in
#: this order ("rest" takes what matches none)
PROFILE_SPLIT = (("embedding_bag", ("embedding_bag",)),
                 ("paged_decode", ("paged_decode",)),
                 ("moe_dispatch", ("dispatch_kernel",)),
                 ("moe_combine", ("combine_kernel",)),
                 ("moe_positions", ("positions_kernel",)),
                 ("flash_fwd", ("fwd_kernel",)),
                 ("flash_bwd", ("dkdv_kernel", "delta_kernel", "dq_kernel")),
                 ("matmul", ("gemm", "gemv", "nvjet")),
                 ("copies", ("copy",)))


def device_split(torch, prof, steps: int, label: str, calls=None):
    """(device busy ms, {kernel group: ms}, kernel launches) per step from
    a ``torch.profiler`` run of ``steps`` steps; ``calls``, a dict, gets
    each group's kernel count over the run."""
    from torch.autograd import DeviceType

    split = {name: 0.0 for name, _ in PROFILE_SPLIT}
    split["rest"] = 0.0
    counts = dict.fromkeys(split, 0)
    dev_us, launches = 0.0, 0
    rest = {}
    for e in prof.key_averages():
        if e.key in ("cudaLaunchKernel", "cuLaunchKernel",
                     "cuLaunchKernelEx", "cudaLaunchKernelExC"):
            launches += e.count
        # a record_function range (the port's spans while a profiler
        # records) has a device extent over the kernels it holds: not a
        # kernel of its own
        if (e.device_type != DeviceType.CUDA
                or getattr(e, "is_user_annotation", False)):
            continue
        t = e.self_device_time_total
        dev_us += t
        key = e.key.lower()
        name = next((n for n, frags in PROFILE_SPLIT
                     if any(f in key for f in frags)), "rest")
        split[name] += t
        counts[name] += e.count
        if name == "rest":
            rest[e.key] = rest.get(e.key, 0.0) + t
    check(dev_us > 0, f"{label}: the profiler saw no device time")
    top = sorted(rest.items(), key=lambda kv: -kv[1])[:3]
    say("profile", f"{label}: the rest's largest kernels: " + "; ".join(
        f"{k[:60]} {t / 1e3 / steps:.3f} ms" for k, t in top))
    if calls is not None:
        calls.update(counts)
    return (dev_us / 1e3 / steps,
            {n: t / 1e3 / steps for n, t in split.items()}, launches / steps)


def profile_split(torch, run, label: str, what: str, steps: int):
    """``run()`` (``steps`` of ``what``) once to warm up, once on the host
    clock and once under ``torch.profiler``: prints the host clock a step
    beside the device time the profiler sees, split by kernel, and returns
    each MoE kernel's device time per call in it (L2 as the layers around
    it leave it)."""
    from torch.profiler import ProfilerActivity, profile

    run()
    t0 = time.perf_counter()
    run()
    wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
    calls = {}
    dev_ms, split, launches = device_split(torch, prof, steps, label, calls)
    idle = 1.0 - dev_ms / wall_ms
    parts = ", ".join(f"{n} {t:.3f}" for n, t in split.items()
                      if t or n in ("matmul", "paged_decode", "rest"))
    say("profile", f"{label} {what}: host clock {wall_ms:.2f} ms/step; "
        f"device busy {dev_ms:.3f} ms/step ({parts}); device idle share "
        f"{idle:.3f}; {launches:.0f} kernel launches/step")
    per_call = {n: split[n] * steps / calls[n] for n in ("moe_dispatch",
                                                         "moe_combine",
                                                         "moe_positions")
                if calls[n]}
    if per_call:
        say("profile", f"{label} {what}, time per call: " + ", ".join(
            f"{n} {t:.4f} ms ({calls[n]} calls)" for n, t in
            per_call.items()))
    return {"per_call": per_call, "host_ms": wall_ms, "device_ms": dev_ms,
            "idle": idle, "launches": launches, "split_ms": split}


def phase_profile(torch, state, label: str, steps: int = 8,
                  compute_dtype=None):
    """``steps`` decode steps at full width (4 slots, KV lengths 77-512),
    split by kernel (:func:`profile_split`)."""
    from repro_torch.models import decoder as dec

    params, cfg_p, cache, tok = state

    def run():
        dec.decode_loop(params, cfg_p, tok, cache, 0, steps,
                        compute_dtype=compute_dtype or torch.float32)
        torch.cuda.synchronize()

    return profile_split(torch, run, label,
                         "decode step at full width, 4 slots", steps)


def phase_prefill_profile(torch, state, label: str, reps: int = 4):
    """``reps`` prefills of one 512-token prompt at full width (the MoE
    layers' routing group is the timing phase's prefill shape, G 1 S 512),
    split by kernel (:func:`profile_split`)."""
    from repro_torch.models import decoder as dec

    params, cfg_p = state[:2]
    cache, prompts, lens = teacher_forced_inputs(torch, dec, cfg_p, [512])

    def run():
        for _ in range(reps):
            dec.prefill(params, cfg_p, prompts, cache, lengths=lens,
                        compute_dtype=torch.float32)
        torch.cuda.synchronize()

    return profile_split(torch, run, label, "512-token prefill at full "
                         "width", reps)


# --------------------------------------------------------------------------
# phases 8-10: training
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


#: phase 9's 2-layer full-width training checks: (arch, batch, sequence)
TEACHER_RUNS = (("llama3.2-1b", 2, 2048), ("olmoe-1b-7b", 2, 512))
#: phase 16's: the flash backward at G 16, at hd 256 with gemma2-2b's
#: window (a sequence past it) and soft cap, and at G 6
ARCH_TEACHER_RUNS = (("chatglm3-6b", 2, 2048), ("gemma2-2b", 1, 4608),
                     ("internlm2-20b", 1, 2048))


def phase_teacher(torch, counters, runs=TEACHER_RUNS, phase="teacher"):
    """One ``loss_fn`` and its gradients through the kernels (flash forward
    and backward; for OLMoE also the MoE Functions) against the plain
    versions (``attn_impl="ref"``, ``moe_impl="slot"``) on the card, at full
    width and 2 layers, float32, for each ``(arch, batch, sequence)`` of
    ``runs``: llama3.2-1b on 2 x 2048 tokens and olmoe-1b-7b on 2 x 512
    (phase 9), chatglm3-6b on 2 x 2048, gemma2-2b (one local and one
    global layer) on 1 x 4608 and internlm2-20b on 1 x 2048 (phase 16).
    Tolerance: the loss to 1e-5 relative, each
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
    for arch, B, S in runs:
        cfg = dataclasses.replace(get_config(arch, reduced=False),
                                  repeats=2 // len(get_config(arch).pattern))
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
                        moe_combine=3 * cfg.num_layers,
                        moe_positions=2 * cfg.num_layers)
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
        say(phase, f"{arch} full width, 2 layers, {B} x {S} tokens: loss "
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
# phase 11: CTR training over the parameter server
# --------------------------------------------------------------------------

#: the CTR runs: steps of the main-path runs (re-pins at 50, 100, 150),
#: of the learning run, and of the multiproc run (re-pins at 20, 40)
CTR_STEPS, CTR_LEARN_STEPS, CTR_MP_STEPS = 200, 1000, 60
CTR_PROFILE_STEPS = 110


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

    # a profiled window of sync steps
    wall_ms = 1e3 / runs["sync"]["steps_per_sec"]
    idle, in_path = ctr_profile(torch, wall_ms, "ctr sync step")
    return {"launches": launches, "mp_launches": mp_launches,
            "learn_launches": learn_launches, "runs": runs,
            "idle_share": idle, "wall_ms": wall_ms, "in_path_ms": in_path}


def ctr_profile(torch, wall_ms: float, label: str):
    """A profiled window of CTR_PROFILE_STEPS sync steps at ``CTRConfig()``
    (the table built before it; re-pins at steps 50 and 100, so the hot
    cache serves the pulls of steps 51-109): prints the device time a step
    split by kernel and the idle share against ``wall_ms``, the unprofiled
    run's step time (the profiler's own host cost stays out of it).
    Returns the idle share and embedding_bag's device time per call."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.ps.workload import CTRConfig, make_table, train_ctr_ps

    cfg = CTRConfig()
    table = make_table(cfg, 4, device="cuda")
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            win = train_ctr_ps(cfg, steps=CTR_PROFILE_STEPS, mode="sync",
                               table=table)
    finally:
        table.close()
    steps = win["steps"]
    calls = {}
    dev_ms, split, kl = device_split(torch, prof, steps, label, calls)
    idle = 1.0 - dev_ms / wall_ms
    check(calls["embedding_bag"] == win["hot_pulls"] > 0,
          f"{label}: {calls['embedding_bag']} embedding_bag kernels in the "
          f"trace for {win['hot_pulls']} pulls that found the cache")
    per_call = split["embedding_bag"] * steps / calls["embedding_bag"]
    parts = ", ".join(f"{n} {t:.4f}" for n, t in split.items() if t)
    say("profile", f"{label}: host clock {wall_ms:.3f} ms/step unprofiled "
        f"({win['seconds'] * 1e3 / steps:.3f} in the {steps} profiled "
        f"steps: pull {win['pull_seconds'] / steps * 1e3:.3f} ms, push "
        f"{win['push_seconds'] / steps * 1e3:.3f} ms); device busy "
        f"{dev_ms:.4f} ms/step ({parts}); device idle share {idle:.4f}; "
        f"{kl:.0f} kernel launches/step; embedding_bag {per_call:.4f} ms a "
        f"call ({calls['embedding_bag']} calls)")
    return idle, per_call


# --------------------------------------------------------------------------
# phase 12: timing at the serve shapes
# --------------------------------------------------------------------------


#: cycles of the spin kernel that keeps the card busy while the host
#: enqueues timed calls (~23 ms at the H100's 1.755 GHz boost clock)
SPIN_CYCLES = 40_000_000


def time_ms(torch, fn, inputs, reps: int = 5, iters: int = 40) -> float:
    """Median over ``reps`` of the mean time of ``iters`` calls, rotating
    over ``inputs`` (sets of arguments larger together than the 50 MB L2,
    so each call reads its K/V from device memory as a decode step does).
    A spin kernel (``torch.cuda._sleep``) holds the card while the host
    enqueues the calls, so the events time the card's work and not the
    host's launch overhead (the profile phases hold the host's share)."""
    for args in inputs:
        fn(*args)
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        for i in range(iters):
            fn(*inputs[i % len(inputs)])
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def flex_attention_call(torch, causal, window, softcap, q_pos=None):
    """``torch.nn.attention.flex_attention`` (eager: PyTorch's unfused
    implementation) with a ``score_mod`` that soft-caps and masks as the
    port's kernels do: the library call for attention with a soft cap,
    which ``scaled_dot_product_attention`` does not take.  ``q_pos``
    (B,): one query a row at that position (decode); else query r sits at
    position r."""
    from torch.nn.attention.flex_attention import flex_attention

    def score_mod(score, b, h, q_idx, kv_idx):
        if softcap is not None:
            score = softcap * torch.tanh(score / softcap)
        qp = q_idx if q_pos is None else q_pos[b]
        ok = (qp >= kv_idx) if causal or q_pos is not None else (
            kv_idx >= 0)
        if window is not None:
            ok = ok & (qp - kv_idx < window)
        return torch.where(ok, score, -float("inf"))

    return lambda q, k, v: flex_attention(q, k, v, score_mod=score_mod)


def paged_timing(torch, pk, *, B, KV, G, hd, ps, P, pos, dtype,
                 window=None, softcap=None):
    """paged_decode at one shape beside its bound, the plain version and
    one library call over the gathered, GQA-expanded K/V (SDPA with the
    causal and window mask; flex_attention where a soft cap is on),
    rotating over enough input sets to exceed the 50 MB L2 three times."""
    F = torch.nn.functional
    el = torch.finfo(dtype).bits // 8
    set_bytes = 2 * (1 + B * P) * ps * KV * hd * el
    sets = [paged_inputs(torch, B=B, KV=KV, G=G, hd=hd, ps=ps, P=P,
                         q_pos=pos, dtype=dtype, seed=100 + i)
            for i in range(max(4, math.ceil(150e6 / set_bytes)))]
    kw = {"window": window, "softcap": softcap}
    kern = time_ms(torch, lambda *a: pk.paged_decode_cuda(*a, **kw), sets)
    plain = time_ms(torch, lambda *a: pk.paged_decode_gather(*a, **kw), sets)

    # library yardstick over the gathered, GQA-expanded K/V
    def gathered(q, kp, vp, table, qp):
        S = P * ps
        k = kp[table.long()].reshape(B, S, KV, hd)
        v = vp[table.long()].reshape(B, S, KV, hd)
        k = k.permute(0, 2, 1, 3).repeat_interleave(G, dim=1)
        v = v.permute(0, 2, 1, 3).repeat_interleave(G, dim=1)
        kpos = torch.arange(S, device="cuda")[None]
        mask = kpos <= qp[:, None].long()
        if window is not None:
            mask &= qp[:, None].long() - kpos < window
        return (q.reshape(B, KV * G, 1, hd), k.contiguous(), v.contiguous(),
                mask[:, None, None, :], qp)

    lib_sets = [gathered(*s) for s in sets[:max(2, len(sets) // 2)]]
    if softcap is None:
        lib_name = "sdpa"

        def lib_fn(q, k, v, m, qp):
            return F.scaled_dot_product_attention(q, k, v, attn_mask=m)
    else:
        lib_name = "flex_attention (eager)"
        calls = {}

        def lib_fn(q, k, v, m, qp):
            if qp.data_ptr() not in calls:
                calls[qp.data_ptr()] = flex_attention_call(
                    torch, True, window, softcap, q_pos=qp.long())
            return calls[qp.data_ptr()](q, k, v)
    o_lib = lib_fn(*lib_sets[0])
    lib = time_ms(torch, lib_fn, lib_sets)
    ref = pk.paged_decode_gather(*sets[0], **kw).reshape(B, KV * G, 1, hd)
    tol = 1e-3 if dtype == torch.float32 else TOL["bfloat16"]
    check((o_lib.float() - ref.float()).abs().max().item() <= tol,
          f"library yardstick ({lib_name}) disagrees with the gather")

    # the least time for this work: the K/V rows at the positions each
    # query sees (q_pos back to its window), the live page-table entries,
    # q, out and q_pos once over the memory rate, or the products' flops
    # over the f32 rate (the soft cap's tanh not counted)
    def seen(p):
        return min(p, P * ps - 1) + 1 if window is None else min(
            min(p, P * ps - 1) + 1, window)

    rows = sum(seen(p) for p in pos)
    live_pages = sum(min(p // ps, P - 1) - (p - seen(p) + 1) // ps + 1
                     for p in pos)
    nbytes = (2 * rows * KV * hd * el + 2 * B * KV * G * hd * el
              + live_pages * 4 + B * 4)
    flops = 4 * rows * KV * G * hd
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS * 1e3
    bound = max(t_bytes, t_ops)
    by = "bytes" if t_bytes >= t_ops else "operations"
    splits, pps = pk.decode_splits(
        B, KV, P, torch.cuda.get_device_properties(0).multi_processor_count)
    shape = (f"B{B} KV{KV} G{G} hd{hd} ps{ps} P{P} {str(dtype)[6:]}, q_pos "
             f"{min(pos)}-{max(pos)}" + (f", window {window}" if window
                                         else "")
             + (f", softcap {softcap:g}" if softcap else "")
             + f", {splits} splits of {pps} pages")
    say("timing", f"paged_decode at {shape}: kernel {kern:.4f} ms, bound "
        f"{bound:.4f} ms ({by}: {nbytes} bytes), gather {plain:.4f} ms, "
        f"{lib_name} on gathered K/V {lib:.4f} ms")
    del sets, lib_sets
    torch.cuda.empty_cache()
    return {"ms": kern, "plain_ms": plain, "bound_ms": bound, "bound_by": by,
            "library_ms": lib, "library": lib_name, "shape": shape}


def phase_timing(torch, pk):
    """paged_decode at the llama decode shape with KV lengths up to 2047
    (float32, the kernel line's numbers; and bfloat16), at the llama
    serve phase's shape (4 slots, 35-page tables, KV lengths 77-512), and
    at phase 16's decode shapes (ARCH_DECODE) in each arch's dtype."""
    res = paged_timing(torch, pk, B=8, KV=8, G=4, hd=64, ps=16, P=128,
                       pos=[2047, 1500, 1023, 700, 333, 64, 15, 0],
                       dtype=torch.float32)
    res["bfloat16"] = paged_timing(
        torch, pk, B=8, KV=8, G=4, hd=64, ps=16, P=128,
        pos=[2047, 1500, 1023, 700, 333, 64, 15, 0], dtype=torch.bfloat16)
    res["shape"] = "llama3.2-1b decode, " + res["shape"]
    res["llama_serve"] = paged_timing(
        torch, pk, B=4, KV=8, G=4, hd=64, ps=16, P=35,
        pos=[76, 200, 350, 511], dtype=torch.float32)
    res["archs"] = {
        arch: paged_timing(torch, pk, B=4, KV=KV, G=G, hd=hd, ps=16, P=P,
                           pos=pos, dtype=getattr(torch, ARCH_DTYPE[arch]),
                           window=w, softcap=sc)
        for arch, KV, G, hd, P, w, sc, pos in ARCH_DECODE}
    return res


def time_cold(torch, fn, args, flush, reps: int = 30,
              clean: bool = False) -> list:
    """Each of ``reps`` calls' time in ms (CUDA events around the call),
    with the L2 cache flushed before each by writing ``flush`` (larger
    than the 50 MB L2), so every call meets its inputs and its output in
    device memory, as a decode step or prefill does.  The flush leaves up
    to 50 MB of dirty lines in L2, written back while the call runs;
    ``clean`` flushes by reading ``flush`` instead, which leaves clean
    lines.  Ten flushed calls first bring the card out of idle."""
    def evict():
        if clean:
            torch.sum(flush[1:], dim=0, out=flush[0])
        else:
            flush.zero_()

    for _ in range(10):
        evict()
        fn(*args)
    torch.cuda.synchronize()
    events = []
    for _ in range(reps):
        evict()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(*args)
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return [s.elapsed_time(e) for s, e in events]


def time_cold_ms(torch, fn, args, flush, reps: int = 30) -> float:
    """Median of :func:`time_cold`."""
    return statistics.median(time_cold(torch, fn, args, flush, reps))


def spread(times) -> dict:
    """Median, min and p90 of per-call times."""
    t = sorted(times)
    return {"median": statistics.median(t), "min": t[0],
            "p90": t[math.ceil(0.9 * len(t)) - 1]}


def fmt_spread(sp) -> str:
    return (f"{sp['median']:.4f} ms (min {sp['min']:.4f}, p90 "
            f"{sp['p90']:.4f})")


def build_earlier(sources) -> dict:
    """Each of ``sources`` (earlier versions of kernel sources, each named
    as its ``csrc/<name>.cu``, e.g. ``git show
    <commit>:src/repro_torch/kernels/csrc/moe.cu`` saved outside the
    package) built with the port's nvcc flags into the build directory,
    one ``nvcc`` each, all started together: {name: loaded library}."""
    import ctypes
    import hashlib

    from repro_torch.kernels import _build

    procs = {}
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    for source in sources:
        path = Path(source).resolve()
        check(path.is_file(), f"--baseline {source}: no such file")
        check(path.stem in KERNELS, f"--baseline {source}: the file name is "
              f"none of the kernel sources {KERNELS}")
        digest = hashlib.sha256(path.read_bytes()).hexdigest()[:16]
        lib = _build.BUILD_DIR / f"lib{path.stem}-earlier-{digest}.so"
        procs[path.stem] = (lib, subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(lib),
             str(path)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        out = proc.communicate(timeout=600)[0]
        check(proc.returncode == 0, f"nvcc failed on the earlier {name}.cu:"
              f"\n{out}")
        libs[name] = ctypes.CDLL(str(lib))
    return libs


@contextlib.contextmanager
def earlier_kernels(modules, libs):
    """Inside the block, each kernel of ``libs`` (from
    :func:`build_earlier`) launches from the earlier library: the build
    cache hands it out and the wrappers' module (``modules[name]``) binds
    its entry points anew, on entering and again on leaving."""
    from repro_torch.kernels import _build

    saved = {name: _build.load(name) for name in libs}
    _build._LIBS.update(libs)
    for name in libs:
        modules[name]._FNS = None
    try:
        yield
    finally:
        _build._LIBS.update(saved)
        for name in libs:
            modules[name]._FNS = None


def time_turns(torch, fn, args, flush, earlier=None) -> dict:
    """``fn(*args)`` timed in turns with the earlier kernels (``earlier``:
    a function that returns :func:`earlier_kernels`' block, or None):
    previous, this, this, previous, else this, this.  A turn times 30
    calls with L2 flushed before each (:func:`time_cold`) and then calls
    back to back with L2 warm (:func:`time_ms`).  Returns, for "this"
    and "previous", the spread of the cold calls, the median of the warm
    turns, and each turn's cold median."""
    turns = (("previous", "this", "this", "previous") if earlier
             else ("this", "this"))
    cold = {who: [] for who in turns}
    warm = {who: [] for who in turns}
    medians = []
    for who in turns:
        with earlier() if who == "previous" else contextlib.nullcontext():
            t = time_cold(torch, fn, args, flush)
            warm[who].append(time_ms(torch, fn, [args]))
        cold[who] += t
        medians.append(f"{who} {statistics.median(t):.4f}")
    return {who: {**spread(cold[who]), "warm": statistics.median(warm[who])}
            for who in cold} | {"turns": ", ".join(medians)}


#: (shape, G, S, D, E, K, dtype name): olmoe-1b-7b's decode (4 slots, one
#: token each) and 512-token prefill in float32 (the kernel line's
#: numbers), qwen3-moe-30b-a3b's and jamba-v0.1-52b's in bfloat16 (their
#: dtype in phases 16 and 17)
MOE_TIMED = (("decode", 4, 1, 2048, 64, 8, "float32"),
             ("prefill", 1, 512, 2048, 64, 8, "float32"),
             ("qwen3 decode", 4, 1, 2048, 128, 8, "bfloat16"),
             ("qwen3 prefill", 1, 512, 2048, 128, 8, "bfloat16"),
             ("jamba decode", 4, 1, 4096, 16, 2, "bfloat16"),
             ("jamba prefill", 1, 512, 4096, 16, 2, "bfloat16"))


def phase_moe_timing(torch, mk, earlier=None):
    """Both MoE kernels at MOE_TIMED's shapes, with L2
    flushed before each call (:func:`time_cold`): combine on the
    contiguous slab and on the strided slab the expert product hands it.  Each is timed by
    :func:`time_turns` (in turns with the ``earlier`` kernels when given)
    and reported as median, min and p90 over its cold calls and its warm
    time, beside an empty kernel timed the same way
    (``torch.cuda._sleep(0)``: the floor of one event-timed launch), the
    least bytes each function needs at 3.35 TB/s, the plain
    version's time and one library call that computes the same function:
    ``F.embedding_bag`` in sum mode with per-sample weights over the
    flattened rows (dispatch: bags of one source row weighted by slot_w;
    combine: bags of a token's K slab rows weighted by w), its flat
    indices built before the timer starts and clamped as the kernels
    clamp."""
    from repro_torch.nn import moe as nn_moe

    F = torch.nn.functional

    def bag(table, idx, wts):
        return F.embedding_bag(idx, table, per_sample_weights=wts,
                               mode="sum")

    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")
    floor = spread(time_cold(torch, torch.cuda._sleep, (0,), flush))
    say("timing", f"empty kernel (torch.cuda._sleep(0)), L2 flushed, event "
        f"timed: {fmt_spread(floor)}")
    res = {"moe_dispatch": {"spread": {}}, "moe_combine": {"spread": {}},
           "floor": floor}
    for shape, G, S, D, E, K, dname in MOE_TIMED:
        dt = getattr(torch, dname)
        el = torch.finfo(dt).bits // 8
        x, src, sw, eid, pos, w, C = moe_inputs(
            torch, nn_moe, mk, G=G, S=S, D=D, E=E, K=K, cf=1.25, dtype=dt,
            seed=11)
        buf = mk.moe_dispatch_cuda(x, src, sw)
        strided = buf.transpose(0, 1).contiguous().transpose(0, 1)
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
        d_lib = (x.reshape(-1, D), d_idx, sw.reshape(-1, 1).to(dt))
        c_lib = (buf.reshape(-1, D), flat.reshape(-1, K),
                 w.reshape(-1, K).to(dt))
        for name, fn, plain, args, lib_args, nbytes, ops in (
                ("moe_dispatch", mk.moe_dispatch_cuda, mk.dispatch_slot,
                 (x, src, sw), d_lib, d_bytes, d_ops),
                ("moe_combine", mk.moe_combine_cuda, mk.combine_slot,
                 (buf, eid, pos, w), c_lib, c_bytes, c_ops)):
            want = plain(*args)
            got = bag(*lib_args).reshape(want.shape)
            err = (got.float() - want.float()).abs().max().item()
            check(err <= MOE_TOL[dname], f"{name} {shape}: embedding_bag "
                  f"disagrees with the plain version by {err:.3e}")
            variants = [("", args)]
            if name == "moe_combine":
                variants.append((" strided slab", (strided, eid, pos, w)))
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            t_ops = ops / F32_FLOPS * 1e3
            bound = max(t_bytes, t_ops)
            by = "bytes" if t_bytes >= t_ops else "operations"
            for how, a in variants:
                tt = time_turns(torch, fn, a, flush, earlier)
                res[name]["spread"][shape + how.replace(" ", "_")] = tt["this"]
                say("timing", f"{name}{how} at {shape} G{G} S{S} E{E} "
                    f"K{K} C{C} D{D} {dname}: kernel {fmt_spread(tt['this'])}"
                    f", warm {tt['this']['warm']:.4f} ms" + (
                        f"; previous kernels {fmt_spread(tt['previous'])}, "
                        f"warm {tt['previous']['warm']:.4f} ms"
                        if earlier else "") + f"; turn medians {tt['turns']}; "
                    f"empty-kernel floor {floor['median']:.4f} ms, bound "
                    f"{bound:.4f} ms ({by}: {nbytes} bytes)")
            kern = res[name]["spread"][shape]["median"]
            plain_ms = time_cold_ms(torch, plain, args, flush)
            lib_ms = time_cold_ms(torch, bag, lib_args, flush)
            res[name][shape] = dict(
                ms=kern, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                library_ms=lib_ms, bytes=nbytes)
            say("timing", f"{name} at {shape} {dname}: kernel {kern:.4f} ms, "
                f"bound {bound:.4f} ms, plain version {plain_ms:.4f} ms, "
                f"embedding_bag {lib_ms:.4f} ms")
    return res


#: (shape, G, S, K, E): olmoe-1b-7b's training step (the benchmark cell's
#: 8 routing groups of 2,048 tokens), its decode (4 slots, one token each)
#: and qwen3-moe-30b-a3b's 512-token prefill
POSITIONS_TIMED = (("olmoe train", 8, 2048, 8, 64),
                   ("olmoe decode", 4, 1, 8, 64),
                   ("qwen3 prefill", 1, 512, 8, 128))


def phase_positions_timing(torch, mk):
    """The position-in-expert kernel at POSITIONS_TIMED's shapes, on the
    top-k ids of random router probabilities as ``moe_route`` hands them
    over (int64, as ``torch.sort`` leaves them): bit-equal to the plain
    version, then timed by :func:`time_turns` (median, min and p90 of its
    cold calls, its warm time) beside the empty-kernel floor, the least
    bytes (the ids read, the positions and flags written, once) at 3.35
    TB/s, the plain version's time (the one-hot ``cumsum``) and, as the
    library call, the bare ``cumsum`` of the one-hot, built before the
    timer starts."""
    from repro_torch.nn import moe as nn_moe

    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")
    floor = spread(time_cold(torch, torch.cuda._sleep, (0,), flush))
    res = {"floor": floor}
    for shape, G, S, K, E in POSITIONS_TIMED:
        g = torch.Generator(device="cuda")
        g.manual_seed(13)
        probs = torch.softmax(torch.randn((G, S, E), generator=g,
                                          device="cuda"), dim=-1)
        eid = nn_moe._top_k(probs, K)[1].reshape(G, S * K)
        C = nn_moe.moe_capacity(S, E, K)

        def plain(e, C=C, E=E):
            return mk.positions_cumsum(e, capacity=C, num_experts=E)

        got, want = mk.moe_positions_cuda(eid, C, E), plain(eid)
        check(all(torch.equal(a, b) for a, b in zip(got, want)),
              f"moe_positions at {shape}: not bit-equal to the cumsum")
        tt = time_turns(torch, mk.moe_positions_cuda, (eid, C, E), flush)
        nbytes = eid.numel() * (eid.element_size() + 4 + 1)
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        plain_ms = time_cold_ms(torch, plain, (eid,), flush)
        onehot = torch.nn.functional.one_hot(eid, E)
        lib_ms = time_cold_ms(torch, lambda t: t.cumsum(dim=1), (onehot,),
                              flush)
        del onehot
        res[shape] = dict(ms=tt["this"]["median"], plain_ms=plain_ms,
                          bound_ms=bound, bound_by="bytes",
                          library_ms=lib_ms, bytes=nbytes, spread=tt["this"])
        say("timing", f"moe_positions at {shape} G{G} S{S} K{K} E{E} C{C} "
            f"int64 ids: kernel {fmt_spread(tt['this'])}, warm "
            f"{tt['this']['warm']:.4f} ms; turn medians {tt['turns']}; "
            f"empty-kernel floor {floor['median']:.4f} ms, bound "
            f"{bound:.6f} ms (bytes: {nbytes}); plain version (one-hot "
            f"cumsum) {plain_ms:.4f} ms, bare cumsum {lib_ms:.4f} ms; "
            "bit-equal")
    return res


#: phase 17's flash shapes (key in the kernel line, B, H, Sq, Sk, hd):
#: whisper-large-v3's encoder self-attention over 1,500 frames, its
#: decoder's and llama-3.2-vision-11b's cross-attention of a 512-token
#: prefill (4 sequences) over 1,500 frames / 1,601 patches; non-causal
FLASH_MIXER_TIMED = (("whisper_encoder", 4, 20, 1500, 1500, 64),
                     ("whisper_cross", 4, 20, 512, 1500, 64),
                     ("vision_cross", 4, 32, 512, 1601, 128))


def phase_flash_timing(torch, fk):
    """:func:`flash_timing_at` llama3.2-1b's training shape (one
    microbatch: 4 x 32 heads x 2048 x hd 64, causal; the kernel line's
    numbers), gemma2-2b's long prefill in phase 16 (1 x 8 heads x 4608
    x hd 256, causal, its local layers' window of 4,096 and soft cap 50)
    and phase 17's non-causal shapes (FLASH_MIXER_TIMED), each in float32
    and bfloat16."""
    res = flash_timing_at(torch, fk, B=4, H=32, S=2048, hd=64)
    res["gemma2_prefill"] = flash_timing_at(torch, fk, B=1, H=8, S=4608,
                                            hd=256, window=4096, softcap=50.0)
    for key, B, H, Sq, Sk, hd in FLASH_MIXER_TIMED:
        res[key] = flash_timing_at(torch, fk, B=B, H=H, S=Sq, Sk=Sk, hd=hd,
                                   causal=False)
    return res


def flash_timing_at(torch, fk, *, B, H, S, hd, Sk=None, causal=True,
                    window=None, softcap=None):
    """The three flash entry points at one shape (S queries over ``Sk``
    keys, default S; causal or not), float32 and
    bfloat16, beside their bounds and plain versions, and the backward as
    a whole
    (the dK/dV pass plus the dQ pass) beside its bound, the plain backward
    and one library call.  The library call is
    ``F.scaled_dot_product_attention`` (with the window as a boolean mask),
    or eager ``flex_attention`` where a soft cap is on (SDPA takes none):
    its forward for the forward, its autograd backward for the whole
    backward; timed only, used nowhere in the port.  No library call computes one pass alone, so each pass's
    ``library_ms`` is null; its plain version is autograd of the plain
    version asked for that pass's outputs only (dK and dV, or dQ).  Each
    input of the llama shape is 67 MB (float32), larger than the 50 MB L2.

    Bounds, from this run's mask (S(S+1)/2 visible pairs per head when
    causal, each row's keys capped at the window when one is on; S·Sk
    when not): each
    product (QKᵀ, PV, dO Vᵀ, dV, dK, dQ) is 2·hd flops a
    visible pair; the forward does 2 of them (2·B·H·S²·hd), the dK/dV pass
    4 (S, dP, dV, dK), the dQ pass 3 (S, dP, dQ); the backward as a whole
    needs 5 (2.5 x the forward).  Rates: bfloat16 989 TFLOP/s (dense
    tensor cores); float32 at both 67 TFLOP/s (CUDA cores) and 495/3
    TFLOP/s (f32-accurate products as three TF32 tensor-core products, as
    the backward runs them), the lower time being the bound and the
    timing line giving both; 3.35 TB/s."""
    F = torch.nn.functional
    BH = B * H
    Sk = Sk or S
    if causal:
        pairs = sum(min(r + 1, window or S, Sk) for r in range(S))
    else:
        check(window is None, "flash_timing_at: a window is timed causal")
        pairs = S * Sk
    mask = {"causal": causal, "window": window, "softcap": softcap}
    label = (f"B{B} H{H} S{S} hd{hd} causal" if causal and Sk == S else
             f"B{B} H{H} Sq{S} Sk{Sk} hd{hd} " + (
                 "causal" if causal else "non-causal")) + (
        f" window {window}" if window else "") + (
        f" softcap {softcap:g}" if softcap else "")
    if softcap is None:
        lib_name = "sdpa"
        keep = None
        if window is not None:
            r = torch.arange(S, device="cuda")
            keep = (r[:, None] >= r[None]) & (r[:, None] - r[None] < window)

        def lib_call(q, k, v):
            if keep is None:
                return F.scaled_dot_product_attention(q, k, v,
                                                      is_causal=causal)
            return F.scaled_dot_product_attention(q, k, v, attn_mask=keep)
    else:
        lib_name = "flex_attention (eager)"
        lib_call = flex_attention_call(torch, causal, window, softcap)
    res = {}
    for dname in ("float32", "bfloat16"):
        dt = getattr(torch, dname)
        el = torch.finfo(dt).bits // 8
        g = torch.Generator(device="cuda")
        g.manual_seed(5)
        q, k, v, do = (torch.randn((B, H, n, hd), generator=g,
                                   device="cuda").to(dt)
                       for n in (S, Sk, Sk, S))
        o, lse = fk.flash_fwd_cuda(q, k, v, **mask)
        _, _, delta = fk.flash_bwd_dkdv_cuda(q, k, v, o, lse, do, **mask)
        mq = BH * S * hd * el           # one (B, H, S, hd) tensor's bytes
        mk = BH * Sk * hd * el          # one (B, H, Sk, hd) tensor's bytes
        row = BH * S * 4                # lse or delta
        work = {                        # (flops, bytes) per entry point
            # q, k, v read; o, lse written
            "flash_fwd": (4 * BH * pairs * hd, 2 * mq + 2 * mk + row),
            # q, o, dO, k, v, lse read; dk, dv, delta written
            "flash_bwd_dkdv": (8 * BH * pairs * hd,
                               3 * mq + 4 * mk + 2 * row),
            # q, dO, k, v, lse, delta read; dq written
            "flash_bwd_dq": (6 * BH * pairs * hd, 3 * mq + 2 * mk + 2 * row),
            # q, o, dO, k, v, lse read; dq, dk, dv written
            "backward_total": (10 * BH * pairs * hd,
                               4 * mq + 4 * mk + row),
        }
        kern = {
            "flash_fwd": time_ms(torch, lambda: fk.flash_fwd_cuda(
                q, k, v, **mask), [()], reps=5, iters=3),
            "flash_bwd_dkdv": time_ms(torch, lambda: fk.flash_bwd_dkdv_cuda(
                q, k, v, o, lse, do, **mask), [()], reps=5, iters=3),
            "flash_bwd_dq": time_ms(torch, lambda: fk.flash_bwd_dq_cuda(
                q, k, v, do, lse, delta, **mask), [()], reps=5, iters=3),
        }
        kern["backward_total"] = kern["flash_bwd_dkdv"] + kern["flash_bwd_dq"]
        qkv = [t.clone().requires_grad_(True) for t in (q, k, v)]
        out = fk.flash_attention_ref(*qkv, **mask)

        def plain_grads(wrt):
            return time_ms(torch, lambda: torch.autograd.grad(
                out, wrt, do, retain_graph=True), [()], reps=3, iters=2)

        plain = {
            "flash_fwd": time_ms(torch, lambda: fk.flash_attention_ref(
                q, k, v, **mask), [()], reps=3, iters=2),
            "flash_bwd_dkdv": plain_grads(qkv[1:]),
            "flash_bwd_dq": plain_grads(qkv[:1]),
            "backward_total": plain_grads(qkv),
        }
        lib_out = lib_call(*qkv)
        err = (lib_out.float() - out.float()).abs().max().item()
        check(err <= 10 * FLASH_TOL[dname], f"{lib_name} {dname} at {label} "
              f"disagrees with the plain version by {err:.3e}")
        lib = {
            "flash_fwd": time_ms(torch, lambda: lib_call(q, k, v), [()],
                                 reps=5, iters=3),
            "flash_bwd_dkdv": None, "flash_bwd_dq": None,
            "backward_total": time_ms(torch, lambda: torch.autograd.grad(
                lib_out, qkv, do, retain_graph=True), [()], reps=5, iters=3),
        }
        del out, lib_out, qkv
        for name, (flops, nbytes) in work.items():
            # float32: 3xTF32 is the faster of the two rates
            peak = TF32X3_FLOPS if dname == "float32" else BF16_TC_FLOPS
            t_ops = flops / peak * 1e3
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            res.setdefault(name, {})[dname] = {
                "ms": kern[name], "plain_ms": plain[name],
                "bound_ms": max(t_ops, t_bytes),
                "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                "library_ms": lib[name], "flops": flops, "bytes": nbytes,
                "library": lib_name, "shape": f"{label} {dname}"}
            rate = (f"{peak / 1e12:.0f} TFLOP/s"
                    + (f"; {flops / F32_FLOPS * 1e3:.4f} ms at the CUDA "
                       "cores' 67" if dname == "float32" else ""))
            lib_ms = "none" if lib[name] is None else f"{lib[name]:.4f} ms"
            say("timing", f"{name} at {label} {dname}: kernel "
                f"{kern[name]:.4f} ms, bound {max(t_ops, t_bytes):.4f} ms "
                f"({flops} flops at {rate}, {nbytes} bytes), plain "
                f"{plain[name]:.4f} ms, {lib_name} {lib_ms}")
        del q, k, v, do, o, lse, delta
        torch.cuda.empty_cache()
    return res


#: (label, N, bag, V, dim, bfloat16 too): the CTR hot-cache lookup, the
#: reference benchmark's pooled shape (benchmarks/bench_kernels.py), a
#: large pooled shape and long bags (the paper's CTR bags run to hundreds
#: of rows) over a table that L2 mostly holds
BAG_TIMED = (("ctr hot-cache lookup", 6656, 1, 4096, 16, False),
             ("bench pooled", 256, 26, 100_000, 128, True),
             ("large pooled", 16_384, 26, 1_000_000, 128, True),
             ("long bags", 4096, 300, 100_000, 128, True))


def phase_bag_timing(torch, bk, earlier=None):
    """embedding_bag at BAG_TIMED's shapes, float32 and (pooled) bfloat16,
    each timed by :func:`time_turns` (in turns with the ``earlier`` kernel
    when given): median, min and p90 of its cold calls (L2 flushed before
    each) and its warm time, beside an empty kernel timed the same way,
    the least bytes at 3.35 TB/s, the cold time after a flush that leaves
    L2 clean (:func:`time_cold`'s ``clean``) and, in float32, the plain
    version's and ``F.embedding_bag(mode="sum")``'s cold medians."""
    F = torch.nn.functional
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")
    floor = spread(time_cold(torch, torch.cuda._sleep, (0,), flush))
    say("timing", f"empty kernel (torch.cuda._sleep(0)), L2 flushed, event "
        f"timed: {fmt_spread(floor)}")
    g = torch.Generator(device="cuda")
    g.manual_seed(3)
    res = {"floor": floor}
    for label, N, bag, V, dim, bf16 in BAG_TIMED:
        ids = torch.randint(0, V, (N, bag), generator=g, device="cuda",
                            dtype=torch.int32)
        table = torch.randn((V, dim), generator=g, device="cuda")
        rows = torch.unique(ids).numel()
        shape = f"N{N} bag{bag} V{V} dim{dim}"
        for dt in (torch.float32, torch.bfloat16) if bf16 else (
                torch.float32,):
            dname = str(dt)[6:]
            tab = table.to(dt)
            el = tab.element_size()
            # the least bytes: the ids, each distinct row they name, the
            # output; one add per element of every row
            nbytes = N * bag * 4 + rows * dim * el + N * dim * el
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            t_ops = N * bag * dim / F32_FLOPS * 1e3
            bound = max(t_bytes, t_ops)
            by = "bytes" if t_bytes >= t_ops else "operations"
            tt = time_turns(torch, bk.embedding_bag_cuda, (ids, tab), flush,
                            earlier)
            clean = spread(time_cold(torch, bk.embedding_bag_cuda,
                                     (ids, tab), flush, clean=True))
            out = {"ms": tt["this"]["median"], "bound_ms": bound,
                   "bound_by": by, "bytes": nbytes, "spread": tt["this"],
                   "clean_l2_ms": clean["median"],
                   "shape": f"{shape} {dname}"}
            if earlier:
                out["previous"] = tt["previous"]
            extra = ""
            if dt == torch.float32:
                ids64 = ids.long()
                lib = F.embedding_bag(ids64, tab, mode="sum")
                err = (lib - bk.embedding_bag_ref(ids, tab)).abs().max().item()
                check(err <= bag_tol("float32", bag)[0], f"{label}: "
                      "F.embedding_bag disagrees with the plain version by "
                      f"{err:.3e}")
                out["plain_ms"] = time_cold_ms(torch, bk.embedding_bag_ref,
                                               (ids, tab), flush)
                out["library_ms"] = time_cold_ms(
                    torch, lambda i, t: F.embedding_bag(i, t, mode="sum"),
                    (ids64, tab), flush)
                extra = (f", plain {out['plain_ms']:.4f} ms, F.embedding_bag "
                         f"{out['library_ms']:.4f} ms")
                del ids64, lib
                res[label] = out
            else:
                res[label][dname] = out
            say("timing", f"embedding_bag {label} {shape} {dname}: kernel "
                f"{fmt_spread(tt['this'])}, warm {tt['this']['warm']:.4f} ms"
                + (f"; previous kernel {fmt_spread(tt['previous'])}, warm "
                   f"{tt['previous']['warm']:.4f} ms" if earlier else "")
                + f"; turn medians {tt['turns']}; after a clean flush "
                f"{fmt_spread(clean)}; empty-kernel floor "
                f"{floor['median']:.4f} ms, bound {bound:.5f} ms ({by}: "
                f"{nbytes} bytes, {rows} distinct rows){extra}")
            del tab
        del ids, table
        torch.cuda.empty_cache()
    return res


# --------------------------------------------------------------------------
# phase 13: the scheduler — the paper's Table-3 cases, fused RL on the card
# --------------------------------------------------------------------------

#: the paper's Table 3: four models on the CPU + V100 fleet, and MATCHNET
#: on 32 resource types (two fleet-size groups in one schedule_many call)
TABLE3 = (("MATCHNET", 2), ("CTRDNN", 2), ("2EMB", 2), ("NCE", 2),
          ("MATCHNET", 32))
SCHED_PLANS, SCHED_SEED = 4096, 0
SCHED_BASELINES = ("Greedy", "Heuristic", "GPU", "CPU")


def table3_specs():
    from repro_torch.core import (TrainingJob, default_fleet, make_fleet,
                                  paper_model_profiles)

    job = TrainingJob()
    specs = []
    for model, types in TABLE3:
        fleet = default_fleet() if types == 2 else make_fleet(types)
        specs.append((paper_model_profiles(model, fleet), fleet, job))
    return [f"{m}/{t}" for m, t in TABLE3], specs


def search_launches(torch, specs, chunk: int = 5):
    """Kernel launches and device ms a fused round makes for ``specs``
    (one fleet-size group): the difference of two searches of one and two
    chunks, each under ``torch.profiler`` tracing the card only (host ops
    unrecorded, so the tracing costs little), so set-up and the final
    decode cancel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.schedulers import RLScheduler

    seen = []
    for rounds in (chunk, 2 * chunk):
        sched = RLScheduler(rounds=rounds, chunk_rounds=chunk,
                            early_stop_rounds=10 ** 9, device="cuda")
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            sched.schedule_many(specs)
            torch.cuda.synchronize()
        kernels = [e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and not e.key.startswith(("Memcpy", "Memset"))]
        check(kernels, "sched search: the profiler saw no kernel")
        seen.append((sum(e.count for e in kernels),
                     sum(e.self_device_time_total for e in kernels) / 1e3))
    return ((seen[1][0] - seen[0][0]) / chunk,
            (seen[1][1] - seen[0][1]) / chunk)


def check_no_host_sync(torch, specs):
    """One fused round's device work — sampling, ``soft_cost``, the
    REINFORCE gradient, the Adam step — with CUDA's sync debug mode set to
    error: any operation that waits for the card raises here."""
    import numpy as np

    from repro_torch.core import torch_cost
    from repro_torch.core.schedulers import policy as pol
    from repro_torch.core.schedulers.rl import _adam_update

    profiles, fleet, job = specs[0]
    T, L = len(fleet), len(profiles)
    ct = torch_cost.cost_tensors(profiles, fleet, job, device="cuda")
    feats = torch.as_tensor(pol.layer_features(profiles), device="cuda")
    policy = pol.init_policy("lstm", feats.shape[1] + T, 64, T,
                             device="cuda")
    g = pol.gumbel_noise(torch.Generator().manual_seed(0),
                         (32, L, T)).to("cuda")
    opt = ([torch.zeros_like(p) for p in policy.params()],
           [torch.zeros_like(p) for p in policy.params()], 0)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        actions, logps = pol.sample(policy, feats, g, temperature=2.0)
        sc = torch_cost.soft_cost(ct, actions)
        adv = (-torch.log10(sc.soft + 1e-12)).to(torch.float32)
        grads = torch.autograd.grad(logps, policy.params(),
                                    grad_outputs=adv / 32)
        _adam_update(policy.params(), grads, opt, 0.03)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    check(bool(np.isfinite(sc.soft.cpu().numpy()).all()),
          "sync check: non-finite soft costs")
    say("sched", "one fused round's device work ran with the sync debug "
        "mode at 'error': no host sync")


def phase_sched(torch):
    """The Table-3 cases in one ``RLScheduler().schedule_many`` call on the
    card (150 rounds x 32 plans by default): each plan's device-scored cost
    against the NumPy oracle and no worse than the Greedy, Heuristic, GPU
    and CPU baselines; ``torch_cost.soft_cost`` on the card against the
    CPU and the oracle for 4,096 random plans a model; the search's rate
    beside the same search on the CPU and the unfused loop's."""
    import numpy as np

    from repro_torch.core import batched_soft_plan_cost, plan_cost
    from repro_torch.core.schedulers import ALL_SCHEDULERS, RLScheduler
    from repro_torch.core.torch_cost import torch_soft_plan_cost

    labels, specs = table3_specs()
    check_no_host_sync(torch, specs)
    # 1. the search on the card: one call, two fleet-size groups
    t0 = time.perf_counter()
    res = RLScheduler(device="cuda").schedule_many(specs)
    wall = time.perf_counter() - t0
    rng = np.random.default_rng(SCHED_SEED)
    flips = 0
    for label, r, (profiles, fleet, job) in zip(labels, res, specs):
        check(r.extra["fused"] and r.extra["device"].startswith("cuda"),
              f"{label}: the search did not run fused on the card")
        check(math.isfinite(r.cost), f"{label}: no feasible plan")
        oracle, _ = plan_cost(r.plan, profiles, fleet, job)
        soft, card_cost, feas = torch_soft_plan_cost(
            np.asarray([r.plan.assignment]), profiles, fleet, job,
            device="cuda")
        check(bool(feas[0]) and math.isclose(card_cost[0], oracle,
                                             rel_tol=1e-9),
              f"{label}: card cost {card_cost[0]!r} vs NumPy plan_cost "
              f"{oracle!r} (rtol 1e-9)")
        base = {}
        for name in SCHED_BASELINES:
            b = ALL_SCHEDULERS[name]().schedule(profiles, fleet, job)
            base[name] = b.cost
            check(r.cost <= b.cost * (1 + 1e-12),
                  f"{label}: RL {r.cost!r} worse than {name} {b.cost!r}")
        say("sched", f"{label}: RL-LSTM cost {r.cost:.6g} (card "
            f"{card_cost[0]:.6g}, rel err "
            f"{abs(card_cost[0] - oracle) / oracle:.1e}); " + ", ".join(
                f"{n} {c:.6g}" for n, c in base.items())
            + f"; {r.extra['rounds']} rounds, {r.evaluations} plans scored")

        # 2. soft_cost on the card vs the CPU and the NumPy oracle
        A = rng.integers(0, len(fleet), (SCHED_PLANS, len(profiles)))
        card = torch_soft_plan_cost(A, profiles, fleet, job, device="cuda")
        cpu = torch_soft_plan_cost(A, profiles, fleet, job, device="cpu")
        bc, nsoft = batched_soft_plan_cost(A, profiles, fleet, job)
        # the search re-verifies a card-feasible winner against the oracle
        # (_select_plan); a plan the card calls infeasible and the oracle
        # feasible would be lost without a trace
        lost = int(np.sum(~card[2] & bc.feasible))
        both = (card[2] == cpu[2]) & (card[2] == bc.feasible)
        flips += int(np.sum(~both))
        err = max(float(np.max(np.abs(card[0][both] - ref[both])
                               / np.abs(ref[both])))
                  for ref in (cpu[0], nsoft))
        check(lost == 0, f"{label}: {lost} plans infeasible on the card "
              "but feasible by the oracle")
        check(err <= 1e-9, f"{label}: soft cost card vs CPU/oracle rel err "
              f"{err:.2e} > 1e-9")
        say("sched", f"{label}: soft_cost of {SCHED_PLANS} random plans, "
            f"card vs CPU and NumPy: max rel err {err:.2e} (rtol 1e-9), "
            f"feasibility disagreements {int(np.sum(~both))} (card "
            f"infeasible, oracle feasible: {lost}); "
            f"{int(bc.feasible.sum())} feasible")

    # 3. rates: per group on the card, the same search on the CPU, the
    # unfused loop (NumPy-scored) on the CPU
    cpu_res = RLScheduler(device="cpu").schedule_many(specs)
    unfused = RLScheduler(fused=False, device="cpu").schedule_many(specs)
    groups = {}
    for i, (_, fleet, _) in enumerate(specs):
        groups.setdefault(len(fleet), []).append(i)
    for types, idx in groups.items():
        names = ", ".join(labels[i] for i in idx)
        launches, dev_ms = search_launches(torch, [specs[i] for i in idx])
        r, c = res[idx[0]], cpu_res[idx[0]]
        host_ms = 1e3 / r.extra["rounds_per_s"]
        u_rate = [unfused[i].extra["rounds_per_s"] for i in idx]
        say("sched", f"group of {len(idx)} on {types} types ({names}): card "
            f"{r.extra['rounds_per_s']:.2f} rounds/s steady, first chunk "
            f"{r.extra['chunk_s'][0]:.3f} s ({r.extra['compile_s']:.3f} s "
            f"beyond a steady one), {launches:.0f} kernel launches and "
            f"{dev_ms:.3f} ms of device time a round (device idle share "
            f"{1 - dev_ms / host_ms:.3f}), group wall {r.wall_time_s:.2f} s "
            f"for {max(res[i].extra['rounds'] for i in idx)} rounds; CPU "
            f"{c.extra['rounds_per_s']:.2f} rounds/s, wall "
            f"{c.wall_time_s:.2f} s; unfused on the CPU "
            + ", ".join(f"{u:.2f}" for u in u_rate) + " rounds/s")
        for i in idx:
            same = res[i].plan.assignment == cpu_res[i].plan.assignment
            say("sched", f"{labels[i]}: card plan {'=' if same else '!='} "
                f"CPU plan; costs card {res[i].cost:.6g}, CPU "
                f"{cpu_res[i].cost:.6g}, unfused {unfused[i].cost:.6g}")
    say("sched", f"schedule_many on the card: {wall:.2f} s for "
        f"{len(specs)} models; soft_cost feasibility disagreements in all: "
        f"{flips}")


# --------------------------------------------------------------------------
# phase 14: serve --continuous --replan at full width
# --------------------------------------------------------------------------

def phase_replan(torch, counters):
    """The serve CLI's ``--replan`` wiring (``launch.serve.replan_
    controller``: the fused search on the card at start-up, a window every
    0.5 s that tunes admission) around ``serve_continuous`` of llama3.2-1b
    at full width on phase 5's mix, with every launch count set to 0 just
    before the serving run and read just after.  One tick just before
    serving opens the first window, so the windows cover the run (the CLI
    opens it one period after start-up)."""
    from repro_torch.configs import get_config
    from repro_torch.core.admission import AdmissionPolicy
    from repro_torch.launch import serve as serve_cli
    from repro_torch.models import decoder as dec

    cfg = get_config("llama3.2-1b", reduced=False)
    params = dec.init_model(cfg, seed=0, device="cuda")
    # the same mix once first, as in phase 5
    serve_cli.serve_continuous("llama3.2-1b", reduced=False, device="cuda",
                               requests=REQUESTS, slots=4, params=params)
    args = serve_cli.build_parser().parse_args(
        ["--no-reduced", "--continuous", "--replan", "--replan-window-s",
         "0.5", "--device", "cuda"])
    policy = AdmissionPolicy(slots=4)
    t0 = time.perf_counter()
    controller = serve_cli.replan_controller(args, policy)
    search_s = time.perf_counter() - t0
    controller.start()
    controller.tick()
    for fn in counters.values():
        fn.launches = 0
    try:
        out = serve_cli.serve_continuous(
            "llama3.2-1b", reduced=False, device="cuda", requests=REQUESTS,
            slots=4, params=params, admission=policy)
    finally:
        controller.stop()
    launches = {name: fn.launches for name, fn in counters.items()}
    rep = controller.report()
    check(out["outcomes"] == ["completed"] * len(REQUESTS),
          f"replan serve outcomes {out['outcomes']}")
    check(out["tokens_in_vocab"] and out["pool_conserved"],
          "replan serve: tokens outside the vocabulary or pool not conserved")
    check("errors" not in rep, f"controller ticks raised: {rep.get('errors')}")
    check(rep["windows"] >= 1, f"controller completed {rep['windows']} "
          f"windows in a {out['wall_s']:.2f} s run")
    check("admission" in rep, "no admission report")
    check(math.isfinite(rep["incumbent"]["cost"]),
          f"infeasible incumbent {rep['incumbent']}")
    layers = cfg.num_layers
    check(launches["paged_decode"] == layers * out["decode_steps"],
          f"replan serve: paged_decode launches {launches['paged_decode']} "
          f"!= {layers} x {out['decode_steps']} steps")
    check_prefill_flash(launches, layers, out["prefills"],
                        "llama3.2-1b with --replan")
    adm = rep["admission"]
    say("replan", f"start-up search on the card {search_s:.2f} s; incumbent "
        f"{rep['incumbent']['assignment']} cost "
        f"{rep['incumbent']['cost']:.6g}; {len(REQUESTS)} requests "
        f"completed in {out['wall_s']:.2f} s, {rep['windows']} windows, "
        f"{rep['calibrations']} calibrations, {rep['considered']} re-plans "
        f"considered; admission: {len(adm['decisions'])} decisions, "
        f"queue bound {adm['queue_bound']}, max concurrency "
        f"{adm['max_concurrency']}; launches {launches}")
    return launches


# --------------------------------------------------------------------------
# phase 15: the elastic PS fleet, chaos and fleet checkpoints
# --------------------------------------------------------------------------

#: benchmarks/bench_chaos.py's schedules: every fault kind the transport's
#: retries must mask, interleaved; and a correlated loss of both replicas
#: of every bucket (global attempt ~170, about step 14 on 3 shards)
MASK_SCHED = ("drop_reply,op=grad,after=10,times=2;"
              "drop_reply,op=grad,after=120,times=2;"
              "dup_reply,op=pull,after=5,times=2;"
              "dup_reply,op=pull,after=150,times=2;"
              "recv_error,after=30,times=2;"
              "recv_error,after=200,times=2;"
              "delay,delay_s=0.001,prob=0.3")
KILL_BOTH = ("crash,op=grad,shard=0,after=170,times=1;"
             "crash,op=grad,shard=1,after=170,times=1")
#: checkpoints every 5 steps, as bench_chaos.py takes them: the drains'
#: attempts place KILL_BOTH's two crashes in one push (step 13); every 10
#: steps they land a step apart, and replica recovery between them
#: survives the second
ELASTIC_STEPS, ELASTIC_CKPT_EVERY = 200, 5
ELASTIC_EVENTS = [(40, "join", None), (80, "kill", 0)]
#: the re-planning reasons a shard kill raises
KILL_REASONS = {"fleet_events", "ps_degraded"}


def tally(xs) -> dict:
    """How often each value occurs in ``xs``, in first-seen order."""
    return {k: xs.count(k) for k in dict.fromkeys(xs)}


def elastic_line(label, out):
    n = out["steps"]
    say("elastic", f"{label}: {n} steps, {out['steps_per_sec']:.2f} steps/s;"
        f" pull {out['pull_seconds'] / n * 1e3:.3f} ms, push "
        f"{out['push_seconds'] / n * 1e3:.3f} ms a step; loss "
        f"{out['first_loss']:.4f} -> {out['last_loss']:.4f}; events "
        f"{tally([e['kind'] for e in out['events']])}, recovery "
        f"{out['recovery_seconds']:.4f} s, join {out['join_seconds']:.4f} s;"
        f" live shards {out['live_shards']}; tower on "
        f"{out['devices']['tower']}")


def phase_elastic(torch, counters):
    """``train_ctr_elastic`` at ``CTRConfig()`` on the card (the tower and
    the push's dedup there, 3 in-process shard servers with PS-hosted
    optimizers, one backup per bucket), with every launch count set to 0
    just before the runs and read just after (the fleet has no hot cache:
    no kernel of ours runs).  Sync adagrad calm, with a join and a kill,
    under the masking schedule and under the loss of both replicas with
    checkpoints every 5 steps: each bit-equal to the calm run's losses;
    async adam with the join and the kill."""
    import tempfile

    from repro_torch import obs
    from repro_torch.ps.workload import CTRConfig, train_ctr_elastic

    cfg = CTRConfig()
    say("elastic", f"CTRConfig(): vocab {cfg.vocab}, emb_dim {cfg.emb_dim}, "
        f"{cfg.slots} slots, tower {cfg.tower}, batch {cfg.batch}; 3 "
        "in-process shard servers, 12 buckets, one backup each")
    kw = dict(steps=ELASTIC_STEPS, num_shards=3, optimizer="adagrad",
              mode="sync", device="cuda")
    reg = obs.REGISTRY
    ckpt_keys = ("saves", "bytes", "ms")
    for fn in counters.values():
        fn.launches = 0
    runs = {"calm": train_ctr_elastic(cfg, **kw)}
    runs["join + kill"] = train_ctr_elastic(cfg, **kw, events=ELASTIC_EVENTS)
    runs["masked faults"] = train_ctr_elastic(
        cfg, **kw, fault_schedule=MASK_SCHED, fault_seed=0)
    with tempfile.TemporaryDirectory() as d:
        was = reg.enabled
        reg.enabled = True       # the checkpoint writer's own counters
        before = {k: reg.counter(f"ps.ckpt.{k}").value for k in ckpt_keys}
        try:
            runs["both replicas lost"] = train_ctr_elastic(
                cfg, **kw, fault_schedule=KILL_BOTH, fault_seed=0,
                ckpt_dir=d, ckpt_every=ELASTIC_CKPT_EVERY)
        finally:
            reg.enabled = was
        ckpt = {k: reg.counter(f"ps.ckpt.{k}").value - before[k]
                for k in ckpt_keys}
    runs["async adam, join + kill"] = train_ctr_elastic(
        cfg, **dict(kw, optimizer="adam", mode="async"),
        events=ELASTIC_EVENTS)
    launches = {name: fn.launches for name, fn in counters.items()}

    for label, out in runs.items():
        elastic_line(label, out)
        check(out["steps"] == ELASTIC_STEPS
              and all(math.isfinite(x) for x in out["losses"]),
              f"{label}: {out['steps']} steps, non-finite losses")
        check(out["devices"] == {"tower": ["cuda:0"]},
              f"{label}: tower on {out['devices']}")
    check(all(n == 0 for n in launches.values()),
          f"the elastic runs launched kernels: {launches}")
    calm = runs["calm"]["losses"]
    for label in ("join + kill", "masked faults", "both replicas lost"):
        check(runs[label]["losses"] == calm,
              f"{label}: losses differ from the calm run's")
    hit = runs["join + kill"]
    recovers = [e for e in hit["events"] if e["kind"] == "recover"]
    check(len(recovers) == 1 and recovers[0]["shards"] == [0],
          f"join + kill: recover events {recovers}")
    check(hit["live_shards"] == [1, 2, 3], f"join + kill: live shards "
          f"{hit['live_shards']}")
    masked = runs["masked faults"]
    fired = [i["kind"] for i in masked["injections"]]
    check("crash" not in fired and len(set(fired) - {"delay"}) == 3
          and masked["transport_counters"]["retries"] >= 1,
          f"masked faults: injections {fired}, counters "
          f"{masked['transport_counters']}")
    lost = runs["both replicas lost"]
    restores = [e for e in lost["events"] if e["kind"] == "restore"]
    crashes = sum(i["kind"] == "crash" for i in lost["injections"])
    saved = [s for s, _ in lost["checkpoints"]]
    check(lost["restores"] >= 1 and restores and crashes == 2,
          f"both replicas lost: {lost['restores']} restores, {crashes} "
          "crashes")
    check(saved[-1] == ELASTIC_STEPS - 1 and all(
        (s + 1) % ELASTIC_CKPT_EVERY == 0 for s in saved),
          f"both replicas lost: checkpoints at steps {saved}")
    check(ckpt["saves"] >= len(saved) and ckpt["bytes"] > 0,
          f"checkpoint counters {ckpt}")
    arun = runs["async adam, join + kill"]
    arec = [e for e in arun["events"] if e["kind"] == "recover"]
    # the puller and the pusher may both trip over the dead shard: the
    # second recovery finds nothing to re-home but still logs an event
    check(1 <= len(arec) <= 2 and all(e["shards"] == [0] for e in arec),
          f"async: recover events {arec}")
    say("elastic", f"calm vs join + kill, masked faults ({len(fired)} "
        f"injections: {tally(fired)}; transport "
        f"{masked['transport_counters']}; events "
        f"{tally([e['kind'] for e in masked['events']])}) and both "
        f"replicas lost: {ELASTIC_STEPS} losses bit-equal")
    say("elastic", f"both replicas lost: {crashes} crashes, "
        f"{lost['restores']} restore(s) of {restores[0]['seconds']:.4f} s "
        f"from step {restores[0]['step']}; {ckpt['saves']:.0f} checkpoints "
        f"written, "
        f"{ckpt['bytes'] / ckpt['saves'] / 1e6:.2f} MB and "
        f"{ckpt['ms'] / ckpt['saves']:.1f} ms each (writer thread); "
        f"async recover events {len(arec)}; launches {launches}")
    return {"runs": runs, "ckpt": ckpt, "launches": launches}


def count_syncs(torch, fn) -> int:
    """The host syncs ``torch.cuda.set_sync_debug_mode`` reports while
    ``fn()`` runs (a prototype that may miss some: a lower bound)."""
    import warnings

    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(w.message) for w in seen)


def elastic_step_syncs(torch):
    """The host syncs of one sync elastic step at ``CTRConfig()`` on the
    card, split into the pull, the tower step with its loss read, and
    the push (after one step unwatched)."""
    from repro_torch.ps.workload import (
        CTRConfig, click_stream, init_tower, make_fleet, make_step_fn,
    )

    cfg = CTRConfig()
    fleet = make_fleet(cfg, 3, optimizer="adagrad", device="cuda")
    try:
        step_fn, state = make_step_fn(cfg), {}
        state["tower"] = init_tower(cfg, device="cuda")
        stream = click_stream(cfg)

        def pull():
            state["b"] = next(stream)
            state["rows"] = fleet.pull(state["b"]["ids"])

        def step():
            labels = torch.from_numpy(state["b"]["label"]).to("cuda")
            state["tower"], state["g"], loss = step_fn(
                state["tower"], state["rows"], labels)
            float(loss)

        def push():
            fleet.push(state["b"]["ids"], state["g"], lr=0.5)

        for part in (pull, step, push):
            part()
        syncs = {part.__name__: count_syncs(torch, part)
                 for part in (pull, step, push)}
    finally:
        fleet.close()
    say("elastic", f"host syncs of one sync step (set_sync_debug_mode, a "
        f"lower bound): {syncs}")
    return syncs


#: the heartbeat's period of the default multiproc transport, seconds
HEARTBEAT_S = 1.0


def phase_elastic_processes(torch):
    """The train CLI over the elastic fleet as a user starts it, on the
    card by default: one shard process each with a kill at step 20, and
    ``--replan`` with the fused search on the card; then a shard process
    SIGKILLed with no traffic in flight, which the heartbeat must report
    within its deadline and the fleet recover from, bit-exactly."""
    import os
    import signal

    from repro_torch.ps.workload import CTRConfig, click_stream, make_fleet

    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(SRC)] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    outs = {}
    for label, args in (
            ("multiproc", ["--ps-transport", "multiproc", "--ps-event",
                           "20:kill:0"]),
            # bandwidth drift parked out of reach, as bench_replan.py
            # parks it: it follows host timing noise, and a bandwidth
            # consideration's cooldown can hide the kill's window
            ("replan", ["--replan", "--replan-window-steps", "5",
                        "--replan-bw-tol", "5.0", "--ps-event",
                        "20:kill:0"])):
        argv = ["--sparse-ps", *args]
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.train", *argv],
            cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
        check(proc.returncode == 0, f"train {' '.join(argv)} exited "
              f"{proc.returncode}:\n{proc.stderr[-3000:]}")
        out = outs[label] = cli_json(proc.stdout)
        kinds = [e["kind"] for e in out["events"]]
        check("recover" in kinds and out["devices"]["tower"] == ["cuda:0"],
              f"train {' '.join(argv)}: events {kinds}, devices "
              f"{out['devices']}")
        say("elastic", f"python -m repro_torch.launch.train "
            f"{' '.join(argv)}: exit 0 in {time.perf_counter() - t0:.1f} s; "
            f"{out['mode']}, {out['steps']} steps, "
            f"{out['steps_per_sec']:.2f} steps/s, events {kinds}, recovery "
            f"{out['recovery_seconds']:.4f} s")
    rep = outs["replan"]["replan"]
    drift = [d for d in rep["decisions"] if d["kind"] == "drift"]
    check("errors" not in rep and rep["calibrations"] == 1
          and rep["considered"] == 1 and len(drift) == 1
          and KILL_REASONS & set(drift[0]["reasons"]),
          f"--replan report: {rep}")
    say("elastic", f"--replan: {rep['windows']} windows, "
        f"{rep['calibrations']} calibration, {rep['considered']} drift "
        f"consideration (window {drift[0]['window']}, "
        f"{drift[0]['reasons']}), {rep['applied']} applied; incumbent "
        f"{rep['incumbent']['assignment']} cost "
        f"{rep['incumbent']['cost']:.6g}")

    cfg = CTRConfig()
    fleet = make_fleet(cfg, 3, optimizer="adagrad", transport="multiproc",
                       device="cuda")
    try:
        b = next(click_stream(cfg))
        g = torch.randn((*b["ids"].shape, cfg.emb_dim),
                        generator=torch.Generator().manual_seed(0))
        fleet.pull(b["ids"])
        fleet.push(b["ids"], g.to(fleet.device), lr=0.5)
        before = fleet.to_dense()
        t0 = time.perf_counter()
        os.kill(fleet.transport._shards[1].proc.pid, signal.SIGKILL)
        detected = None
        while time.perf_counter() - t0 < 5 * HEARTBEAT_S:
            kinds = [e["kind"] for e in fleet.events]
            if detected is None and "detected" in kinds:
                detected = time.perf_counter() - t0
            if "recover" in kinds:
                break
            time.sleep(0.002)
        recovered = time.perf_counter() - t0
        check(detected is not None and detected <= 2 * HEARTBEAT_S
              and "recover" in kinds,
              f"heartbeat: detected after {detected} s, events {kinds}")
        rows = fleet.pull(torch.arange(cfg.vocab))
        check(torch.equal(rows.cpu(), before),
              "rows after the heartbeat's recovery differ from the last "
              "acked state")
    finally:
        fleet.close()
    say("elastic", f"heartbeat: a shard process SIGKILLed with no traffic "
        f"detected after {detected * 1e3:.1f} ms (period "
        f"{HEARTBEAT_S:.1f} s, deadline {2 * HEARTBEAT_S:.1f} s), recovered "
        f"by {recovered * 1e3:.1f} ms; the full table bit-equal after it")
    return outs


# --------------------------------------------------------------------------
# phase 16: chatglm3-6b, gemma2-2b, internlm2-20b and qwen3-moe-30b-a3b
# served at full width; olmoe-1b-7b trained at full depth in bfloat16
# --------------------------------------------------------------------------

#: phase 16's serve runs, in ARCH_DTYPE, each model freed before the next
ARCH_SERVED = ("chatglm3-6b", "gemma2-2b", "internlm2-20b",
               "qwen3-moe-30b-a3b")
#: gemma2-2b's extra request: a prompt past its local layers' window of
#: 4,096, so the window cuts its prefill's and its decode's attention
LONG_REQUEST = (4608, 32)
#: olmoe-1b-7b's bfloat16 training run: steps, batch, sequence, and the
#: sequences of the first batch the kernel path is checked on
OLMOE_TRAIN = (3, 8, 2048, 2)


#: bfloat16 logits after 48 layers, kernels vs plain versions: ulps of
#: the largest |logit|.  The CPU parity tests hold 2 layers at 4; each
#: layer's kernels and plain versions round differently (the gather
#: rounds the attention weights to bfloat16 before P·V, the slot MoE
#: rounds its products, the kernels round once from float32), and 48
#: layers compound it: a first chip call of phase 16 measured 3 ulps
#: (internlm2-20b) and 7 (qwen3-moe-30b-a3b)
BF16_DEEP_ULPS = 16


def bf16_hold(torch, got, want, vocab, what):
    """bfloat16 logits of the kernel path against the plain path's:
    within BF16_DEEP_ULPS ulps of the plain path's largest |logit|, and
    the greedy token equal wherever the plain top-2 margin is wider than
    twice that (elsewhere two tokens are tied within it).  Returns
    (max|d|, the tolerance, the rate at which the greedy tokens
    agree)."""
    got, want = got.float()[..., :vocab], want.float()[..., :vocab]
    tol = bf16_ulps(torch, want, BF16_DEEP_ULPS)
    err = (got - want).abs().max().item()
    check(err <= tol, f"{what}: max|dlogit| {err:.4e} > {BF16_DEEP_ULPS} "
          f"bf16 ulps ({tol:.4e})")
    top2 = want.topk(2, dim=-1).values
    decided = (top2[..., 0] - top2[..., 1]) > 2 * tol
    agree = got.argmax(-1) == want.argmax(-1)
    check(bool(agree[decided].all()), f"{what}: a greedy token differs "
          "where the plain top-2 margin exceeds twice the tolerance")
    return err, tol, agree.float().mean().item()


def arch_teacher(torch, counters, arch, params, dt):
    """4 slots prefilled one at a time through the kernels (as
    ``serve_continuous`` admits them) with prompts of 512, 300, 150 and 77
    tokens (gemma2-2b: 4,608 in place of 512, past its window), then one
    teacher-forced ``decode_step`` through the kernels and through the
    plain versions (``attn_impl="ref"``, ``moe_impl="slot"``, the gather)
    on that cache: float32 logits at atol 1e-3 (phase 5's), bfloat16 by
    :func:`bf16_hold`.  Returns the decode state for the profile and the
    result."""
    from repro_torch.configs import get_config
    from repro_torch.models import decoder as dec

    cfg = get_config(arch)
    layers = cfg.num_layers
    cfg_p = dataclasses.replace(cfg, kv_impl="paged")
    cfg_s = dataclasses.replace(cfg_p, attn_impl="ref", moe_impl="slot")
    plens = [LONG_REQUEST[0] if arch == "gemma2-2b" else 512, 300, 150, 77]
    cache = dec.init_cache(cfg_p, len(plens), max(plens) + 32, dtype=dt,
                           device="cuda")
    g = torch.Generator(device="cuda")
    g.manual_seed(1)
    prompts = torch.randint(0, cfg.vocab, (len(plens), max(plens)),
                            generator=g, device="cuda", dtype=torch.int32)
    toks = []
    for b, n in enumerate(plens):
        sub = dec.slot_cache(cache, b)
        lg, sub = dec.prefill(params, cfg_p, prompts[b:b + 1, :n], sub,
                              compute_dtype=dt)
        cache = dec.merge_slot_cache(cache, sub, b)
        toks.append(lg[0, n - 1, :cfg.vocab].argmax())
        del lg
    tok = torch.stack(toks).to(torch.int32)[:, None]
    n0 = {k: fn.launches for k, fn in counters.items()}
    la, _ = dec.decode_step(params, cfg_p, tok, cache, compute_dtype=dt,
                            impl="auto")
    n1 = {k: fn.launches for k, fn in counters.items()}
    lb, _ = dec.decode_step(params, cfg_s, tok, cache, compute_dtype=dt,
                            impl="gather")
    torch.cuda.synchronize()
    want = {"paged_decode": layers}
    if cfg.has_moe:
        want.update(moe_dispatch=layers, moe_combine=layers,
                    moe_positions=layers)
    launched = {k: n1[k] - n0[k] for k in counters}
    check(all(launched[k] == want.get(k, 0) for k in counters),
          f"{arch} teacher-forced decode_step: launches {launched}, "
          f"expected {want}")
    check(all(fn.launches == n1[k] for k, fn in counters.items()),
          f"{arch}: the plain decode_step launched a kernel")
    check(bool(torch.isfinite(la.float()).all()), f"{arch}: non-finite "
          "decode logits")
    what = f"{arch} teacher-forced decode_step, kernels vs plain versions"
    if dt == torch.float32:
        err, tol = (la - lb).abs().max().item(), 1e-3
        check(err <= tol, f"{what}: max|dlogit| {err:.3e} > 1e-3")
        agree = (la[..., :cfg.vocab].argmax(-1)
                 == lb[..., :cfg.vocab].argmax(-1)).float().mean().item()
    else:
        err, tol, agree = bf16_hold(torch, la, lb, cfg.vocab, what)
    say("archs", f"{what} (prompts {plens}, {str(dt)[6:]}): max|dlogit| "
        f"{err:.4e} (tolerance {tol:.4e}); greedy tokens agree at "
        f"{agree:.3f}")
    return (params, cfg_p, cache, tok), {"max_abs_dlogit": err, "tol": tol,
                                         "greedy_agree": agree}


def phase_archs(torch, counters):
    """ARCH_SERVED at full width and depth, random weights from seed 0 in
    ARCH_DTYPE, one model on the card at a time: ``serve_continuous`` on
    phase 5's mix (gemma2-2b: plus LONG_REQUEST) through
    :func:`counted_serve` (every request completed, the pool conserved,
    ``paged_decode`` launches = layers x decode steps, ``flash_fwd`` =
    layers x prefills, the MoE kernels layers x (decode steps + prefills)),
    :func:`arch_teacher`, and a profiled decode step (host and device ms).
    Prints tok/s, TTFT and peak memory of each."""
    import gc

    from repro_torch.configs import get_config
    from repro_torch.models import decoder as dec
    from repro_torch.tree import tree_leaves

    results = {}
    for arch in ARCH_SERVED:
        dname = ARCH_DTYPE[arch]
        dt = getattr(torch, dname)
        cfg = get_config(arch)
        layers = cfg.num_layers
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        params = dec.init_model(cfg, seed=0, device="cuda", dtype=dt)
        torch.cuda.synchronize()
        n_par = sum(t.numel() for t in tree_leaves(params))
        say("archs", f"{arch} full width: {layers} layers, d_model "
            f"{cfg.d_model}, {cfg.n_heads} heads over {cfg.n_kv_heads} KV "
            f"heads (G {cfg.n_heads // cfg.n_kv_heads}), hd {cfg.head_dim}, "
            f"vocab {cfg.vocab}" + (f", {cfg.moe_experts} experts top-"
                                    f"{cfg.moe_top_k}" if cfg.has_moe else "")
            + f"; {n_par} {dname} parameters from seed 0 in "
            f"{time.perf_counter() - t0:.1f} s; "
            f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated")
        requests = REQUESTS + ([LONG_REQUEST] if arch == "gemma2-2b" else [])
        out, launches = counted_serve(torch, counters, arch, params,
                                      requests=requests, compute_dtype=dt,
                                      phase="archs")
        steps, pre = out["decode_steps"], out["prefills"]
        check(launches["paged_decode"] == layers * steps,
              f"{arch}: paged_decode launches {launches['paged_decode']} != "
              f"{layers} x {steps} steps")
        check_prefill_flash(launches, layers, pre, arch, phase="archs")
        moe = layers * (steps + pre) if cfg.has_moe else 0
        check(launches["moe_dispatch"] == launches["moe_combine"]
              == launches["moe_positions"] == moe,
              f"{arch}: MoE launches {launches['moe_dispatch']} / "
              f"{launches['moe_combine']} / {launches['moe_positions']} != "
              f"{moe}")
        peak = torch.cuda.max_memory_allocated() / 1e9
        state, teacher = arch_teacher(torch, counters, arch, params, dt)
        prof = phase_profile(torch, state, arch, compute_dtype=dt)
        ttft = [t for t in out["ttft_s"] if t is not None]
        results[arch] = {
            "dtype": dname, "params": n_par, "launches": launches,
            "decode_steps": steps, "prefills": pre,
            "decode_tok_per_s": out["decode_tok_per_s_in_chunks"],
            "run_tok_per_s": out["decode_tok_per_s"],
            "ttft_p50_ms": statistics.median(ttft) * 1e3,
            "ttft_max_ms": max(ttft) * 1e3, "peak_gb": peak,
            "step_host_ms": prof["host_ms"],
            "step_device_ms": prof["device_ms"], "idle": prof["idle"],
            "split_ms": prof["split_ms"], "teacher": teacher}
        say("archs", f"{arch} ({dname}): decode {results[arch]['decode_tok_per_s']:.1f}"
            f" tok/s in chunks, TTFT p50 {results[arch]['ttft_p50_ms']:.1f} "
            f"ms, max {results[arch]['ttft_max_ms']:.1f} ms; serve peak "
            f"memory {peak:.2f} GB; a decode step {prof['host_ms']:.2f} ms "
            f"host, {prof['device_ms']:.3f} ms device (idle "
            f"{prof['idle']:.3f})")
        del params, state
        gc.collect()
        torch.cuda.empty_cache()
    return results


def phase_olmoe_train(torch, counters):
    """olmoe-1b-7b at all 16 layers on the card:
    ``init_train_state(dtype=bfloat16)`` (bfloat16 parameters and AdamW
    moments, as the reference keeps the moments in the parameters' dtype)
    and ``make_train_step`` in bfloat16.  Before any update, the loss and
    the global gradient norm through the kernels against the plain
    versions on the same weights and the first OLMOE_TRAIN[3] sequences of
    the first batch (which keeps the plain attention's (B, H, S, S) float32
    scores small beside 55 GB of state and gradients): the loss within
    2^-7 relative (one bfloat16 ulp) and the norm within 2^-5 relative (4
    ulps, the CPU tests' gradient tolerance).  Then OLMOE_TRAIN[0] steps
    of 8 x 2048 tokens in one microbatch (72.6 GB at the peak;
    accumulating microbatches would hold a second 13.8 GB gradient tree).
    Launches per step: the flash forward twice a layer (forward and remat
    recompute), each backward pass once, each MoE kernel 3 times (forward,
    recompute, the other's backward)."""
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticTokenDataset
    from repro_torch.launch.steps import init_train_state, make_train_step
    from repro_torch.models import decoder as dec
    from repro_torch.optim import clip_by_global_norm
    from repro_torch.tree import tree_leaves, tree_unflatten

    steps, B, S, n_check = OLMOE_TRAIN
    bf16 = torch.bfloat16
    cfg = get_config("olmoe-1b-7b")
    layers = cfg.num_layers
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params, opt = init_train_state(cfg, seed=0, device="cuda", dtype=bf16)
    torch.cuda.synchronize()
    n_par = sum(t.numel() for t in tree_leaves(params))
    say("archs", f"olmoe-1b-7b training state: {n_par} bfloat16 parameters "
        f"and two bfloat16 moments in {time.perf_counter() - t0:.1f} s; "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated")
    ds = SyntheticTokenDataset(cfg.vocab, B, S)
    sub = {k: v[:n_check] for k, v in _batch_on_card(torch, ds, 0).items()}

    def loss_and_norm(cfg_x):
        leaves = [t.detach().requires_grad_(True)
                  for t in tree_leaves(params)]
        loss = dec.loss_fn(tree_unflatten(params, leaves), cfg_x, sub,
                           compute_dtype=bf16)
        grads = torch.autograd.grad(loss, leaves)
        _, norm = clip_by_global_norm(tree_unflatten(params, list(grads)),
                                      1.0)
        return loss.item(), norm.item()

    n0 = {k: fn.launches for k, fn in counters.items()}
    loss_k, norm_k = loss_and_norm(cfg)
    n1 = {k: fn.launches for k, fn in counters.items()}
    loss_r, norm_r = loss_and_norm(
        dataclasses.replace(cfg, attn_impl="ref", moe_impl="slot"))
    check(all(fn.launches == n1[k] for k, fn in counters.items()),
          "olmoe-1b-7b: the plain loss_fn launched a kernel")
    check(n1["flash_bwd_dq"] - n0["flash_bwd_dq"] == layers
          and n1["moe_combine"] - n0["moe_combine"] == 3 * layers
          and n1["moe_positions"] - n0["moe_positions"] == 2 * layers,
          f"olmoe-1b-7b: the kernel loss_fn launched "
          f"{ {k: n1[k] - n0[k] for k in counters} }")
    dloss, dnorm = abs(loss_k - loss_r), abs(norm_k - norm_r)
    check(math.isfinite(loss_k) and math.isfinite(norm_k),
          "olmoe-1b-7b: non-finite loss or grad norm")
    check(dloss <= 2 ** -7 * abs(loss_r) and dnorm <= 2 ** -5 * norm_r,
          f"olmoe-1b-7b bfloat16: loss {loss_k} vs plain {loss_r}, grad "
          f"norm {norm_k} vs plain {norm_r}")
    say("archs", f"olmoe-1b-7b bfloat16, 16 layers, {n_check} x {S} tokens, "
        f"kernels vs plain versions: loss {loss_k:.6f} vs {loss_r:.6f} "
        f"(|d| {dloss:.3e}, tolerance {2 ** -7 * abs(loss_r):.3e}), grad "
        f"norm {norm_k:.6f} vs {norm_r:.6f} (|d| {dnorm:.3e}, tolerance "
        f"{2 ** -5 * norm_r:.3e})")
    torch.cuda.empty_cache()

    step = make_train_step(cfg, compute_dtype=bf16, microbatch=None)
    for fn in counters.values():
        fn.launches = 0
    losses, norms, secs = [], [], []
    for i in range(steps):
        batch = _batch_on_card(torch, ds, i)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, m = step(params, opt, batch)
        losses.append(m["loss"].item())
        norms.append(m["grad_norm"].item())
        secs.append(time.perf_counter() - t0)
    launches = {name: fn.launches for name, fn in counters.items()}
    peak = torch.cuda.max_memory_allocated() / 1e9
    per_step = {"flash_fwd": 2 * layers, "flash_bwd_dkdv": layers,
                "flash_bwd_dq": layers, "moe_dispatch": 3 * layers,
                "moe_combine": 3 * layers, "moe_positions": 2 * layers}
    check(all(launches[k] == steps * per_step.get(k, 0) for k in counters),
          f"olmoe-1b-7b train: launches {launches}, expected {steps} x "
          f"{per_step}")
    check(all(math.isfinite(x) for x in losses + norms),
          f"olmoe-1b-7b train: losses {losses}, grad norms {norms}")
    check({t.dtype for t in tree_leaves(params) + tree_leaves(opt.mu)
           + tree_leaves(opt.nu)} == {bf16},
          "olmoe-1b-7b train: a parameter or moment is not bfloat16")
    say("archs", f"olmoe-1b-7b train, 16 layers, bfloat16 parameters and "
        f"moments, {steps} steps of {B} x {S} tokens in one microbatch: "
        f"losses {[round(x, 4) for x in losses]}, grad norms "
        f"{[round(x, 4) for x in norms]}; s/step "
        f"{[round(x, 3) for x in secs]}; peak memory {peak:.2f} GB; "
        f"launches {launches}")
    del params, opt, m
    torch.cuda.empty_cache()
    return {"launches": launches, "losses": losses, "grad_norms": norms,
            "s_per_step": secs, "peak_gb": peak, "dloss": dloss,
            "dnorm": dnorm}


# --------------------------------------------------------------------------
# phase 17: rwkv6-7b, llama-3.2-vision-11b, whisper-large-v3 and
# jamba-v0.1-52b served at full width; their 2-layer training checks
# --------------------------------------------------------------------------

#: phase 17's serve runs in ARCH_DTYPE, each model freed before the next:
#: (arch, repeats or None for full depth).  jamba-v0.1-52b keeps 2 of its
#: 4 repeats of the 8-layer period (16 of 32 layers: 2 attention, 14
#: Mamba, 8 MoE; 26.05 B parameters, 52.1 GB in bfloat16): its full depth
#: needs 103 GB, more than the card holds
MIXER_SERVED = (("rwkv6-7b", None), ("llama-3.2-vision-11b", None),
                ("whisper-large-v3", None), ("jamba-v0.1-52b", 2))
#: the recurrent archs whose prefill is timed per layer (their scans are
#: plain torch: a token loop for RWKV, a doubling scan for Mamba)
SCAN_ARCHS = ("rwkv6-7b", "jamba-v0.1-52b")
#: bfloat16 decode_step logits against the prefill logits of the same
#: tokens (jamba-v0.1-52b, 16 layers): ulps of the largest |logit|.  The
#: one-token and the 513-token paths round every activation to bfloat16
#: after products of other shapes, so they differ by more than kernels
#: and plain versions on one path do
BF16_PREFILL_ULPS = 32


def mixer_counts(cfg) -> dict:
    """Layers of each kind: self-attention (paged decode, a causal flash
    forward a prefill), cross-attention (a non-causal flash forward a
    prefill) and MoE FFNs."""
    def n(pred):
        return cfg.repeats * sum(1 for s in cfg.pattern if pred(s))

    return {"self": n(lambda s: s.mixer in ("attn", "attn+cross")),
            "cross": n(lambda s: s.mixer in ("cross_attn", "attn+cross")),
            "moe": n(lambda s: s.ffn == "moe")}


def mixer_teacher(torch, counters, cfg, params, dt):
    """4 slots prefilled one at a time through the kernels (as
    ``serve_continuous`` admits them) with prompts of 512, 300, 150 and 77
    tokens; then the next prompt token teacher-forced through one
    ``decode_step``, through the kernels and through the plain versions
    (``attn_impl="ref"``, ``moe_impl="slot"``, the gather) on copies of
    that cache, and held: against each other (float32 atol 1e-3,
    bfloat16 :func:`bf16_hold`) and against the logits a prefill of the
    prompt with that token gives at its last position (float32 atol
    2e-3, bfloat16 BF16_PREFILL_ULPS ulps: the recurrent states and shift
    registers the prefill left, stepped once, against the scans over one
    more token); then 16 greedy ``decode_loop`` steps on both paths
    (float32: tokens equal; bfloat16: the agreement printed).  MoE archs
    run this at capacity factor 8, where no token is dropped, as the
    reference's decode-vs-forward test does.  Returns the decode state for
    the profile and the result."""
    from repro_torch.models import decoder as dec
    from repro_torch.tree import tree_map

    n = mixer_counts(cfg)
    cf = 8.0 if cfg.has_moe else cfg.moe_capacity_factor
    cfg_p = dataclasses.replace(cfg, kv_impl="paged", moe_capacity_factor=cf)
    cfg_s = dataclasses.replace(cfg_p, attn_impl="ref", moe_impl="slot")
    plens = [512, 300, 150, 77]
    g = torch.Generator(device="cuda")
    g.manual_seed(1)
    prompts = torch.randint(0, cfg.vocab, (len(plens), max(plens) + 1),
                            generator=g, device="cuda", dtype=torch.int32)
    # room for the 1 + 16 steps here and phase_profile's 3 x 8 after them
    cache = dec.init_cache(cfg_p, len(plens), max(plens) + 64, dtype=dt,
                           device="cuda")
    want = []
    for b, L in enumerate(plens):
        sub = dec.slot_cache(cache, b)
        _, sub = dec.prefill(params, cfg_p, prompts[b:b + 1, :L], sub,
                             compute_dtype=dt)
        cache = dec.merge_slot_cache(cache, sub, b)
        one = dec.init_cache(cfg_p, 1, L + 16, dtype=dt, device="cuda")
        lg, _ = dec.prefill(params, cfg_p, prompts[b:b + 1, :L + 1], one,
                            compute_dtype=dt)
        want.append(lg[0, L:L + 1])
        del one, lg
    want = torch.stack(want)                         # (4, 1, V)
    tok = prompts[torch.arange(len(plens), device="cuda"),
                  torch.tensor(plens, device="cuda")][:, None]
    plain = tree_map(lambda t: t.clone(), cache)    # the state steps in place
    n0 = {k: fn.launches for k, fn in counters.items()}
    la, cache = dec.decode_step(params, cfg_p, tok, cache, compute_dtype=dt,
                                impl="auto")
    n1 = {k: fn.launches for k, fn in counters.items()}
    lb, plain = dec.decode_step(params, cfg_s, tok, plain, compute_dtype=dt,
                                impl="gather")
    torch.cuda.synchronize()
    expect = {"paged_decode": n["self"], "moe_dispatch": n["moe"],
              "moe_combine": n["moe"], "moe_positions": n["moe"]}
    launched = {k: n1[k] - n0[k] for k in counters}
    check(all(launched[k] == expect.get(k, 0) for k in counters),
          f"{cfg.name} teacher-forced decode_step: launches {launched}, "
          f"expected {expect}")
    check(all(fn.launches == n1[k] for k, fn in counters.items()),
          f"{cfg.name}: the plain decode_step launched a kernel")
    check(bool(torch.isfinite(la.float()).all()), f"{cfg.name}: non-finite "
          "decode logits")
    V = cfg.vocab
    res = {}
    for what, a, b in (("kernels vs plain versions", la, lb),
                       ("decode_step vs prefill of the same tokens", la,
                        want)):
        label = f"{cfg.name} teacher-forced {what}"
        if dt == torch.float32:
            tol = 1e-3 if b is lb else 2e-3
            err = (a - b)[..., :V].abs().max().item()
            check(err <= tol, f"{label}: max|dlogit| {err:.3e} > {tol:.0e}")
            agree = (a[..., :V].argmax(-1) == b[..., :V].argmax(-1)).float()
            agree = agree.mean().item()
        elif b is lb:
            err, tol, agree = bf16_hold(torch, a, b, V, label)
        else:
            tol = bf16_ulps(torch, b.float()[..., :V], BF16_PREFILL_ULPS)
            err = (a.float() - b.float())[..., :V].abs().max().item()
            check(err <= tol, f"{label}: max|dlogit| {err:.4e} > "
                  f"{BF16_PREFILL_ULPS} bf16 ulps ({tol:.4e})")
            agree = (a[..., :V].argmax(-1) == b[..., :V].argmax(-1)).float()
            agree = agree.mean().item()
        say("mixers", f"{label} (prompts {plens}, {str(dt)[6:]}): max|dlogit|"
            f" {err:.4e} (tolerance {tol:.4e}); greedy tokens agree at "
            f"{agree:.3f}")
        res[what] = {"max_abs_dlogit": err, "tol": tol, "greedy_agree": agree}
    nxt = lb[..., :V].argmax(-1).to(torch.int32)
    ta, after, cache = dec.decode_loop(params, cfg_p, nxt, cache, 0, 16,
                                       compute_dtype=dt, impl="auto")
    tb, _, _ = dec.decode_loop(params, cfg_s, nxt, plain, 0, 16,
                               compute_dtype=dt, impl="gather")
    same = (ta == tb).float().mean().item()
    check(dt != torch.float32 or same == 1.0, f"{cfg.name}: 16 greedy steps "
          f"through the kernels and the plain versions agree at {same:.3f}")
    say("mixers", f"{cfg.name}: 16 greedy decode steps x 4 slots, kernels vs"
        f" plain versions: tokens agree at {same:.3f}")
    res["greedy_tokens_agree"] = same
    del plain, ta, tb
    return (params, cfg_p, cache, after), res


def scan_prefill_ms(torch, cfg, params, dt, S: int = 512):
    """One ``S``-token prefill (one sequence, as ``serve_continuous``
    admits it) on the host clock and under the profiler: host and device
    ms, per layer and in all."""
    from repro_torch.models import decoder as dec

    cfg_p = dataclasses.replace(cfg, kv_impl="paged")
    cache = dec.init_cache(cfg_p, 1, S + 16, dtype=dt, device="cuda")
    g = torch.Generator(device="cuda")
    g.manual_seed(2)
    prompt = torch.randint(0, cfg.vocab, (1, S), generator=g, device="cuda",
                           dtype=torch.int32)

    def run():
        dec.prefill(params, cfg_p, prompt, cache, compute_dtype=dt)
        torch.cuda.synchronize()

    prof = profile_split(torch, run, cfg.name, f"{S}-token prefill", 1)
    L = cfg.num_layers
    say("mixers", f"{cfg.name} {S}-token prefill: {prof['host_ms']:.1f} ms "
        f"host ({prof['host_ms'] / L:.2f} ms a layer), "
        f"{prof['device_ms']:.1f} ms device ({prof['device_ms'] / L:.3f} ms "
        f"a layer), idle {prof['idle']:.3f}, {prof['launches']:.0f} launches")
    return {"host_ms": prof["host_ms"], "device_ms": prof["device_ms"],
            "host_ms_per_layer": prof["host_ms"] / L,
            "device_ms_per_layer": prof["device_ms"] / L,
            "idle": prof["idle"], "launches": prof["launches"]}


def cross_decode_ms(torch, cfg, params, dt):
    """The one-token cross decode (plain torch: the reference has no TPU
    kernel for it) of 4 slots over the cross k/v, the first cross layer's
    weights, CUDA events around 40 calls."""
    from repro_torch.models import decoder as dec
    from repro_torch.nn import attention as attn_mod

    j = next(i for i, s in enumerate(cfg.pattern)
             if s.mixer in ("cross_attn", "attn+cross"))
    spec = cfg.pattern[j]
    p = dec._layer_views(params["blocks"][j], 0)
    p = p["cross"] if spec.mixer == "attn+cross" else p["mixer"]
    g = torch.Generator(device="cuda")
    g.manual_seed(3)
    B, N, KV, hd = 4, cfg.cross_kv_len, cfg.n_kv_heads, cfg.head_dim
    sets = [((torch.randn((B, 1, cfg.d_model), generator=g, device="cuda")
              .to(dt)),
             {n: torch.randn((B, N, KV, hd), generator=g, device="cuda")
              .to(dt) for n in ("k", "v")}) for _ in range(4)]
    cspec = dec._cross_spec(cfg, spec)
    ms = time_ms(torch, lambda x, kv: attn_mod.decode_attention(
        p, x, kv, 0, cspec, cross=True), sets)
    nbytes = 2 * B * N * KV * hd * (torch.finfo(dt).bits // 8)
    say("mixers", f"{cfg.name} cross decode (plain torch), B{B} H"
        f"{cfg.n_heads} KV{KV} hd{hd} over {N} keys, {str(dt)[6:]}: "
        f"{ms:.4f} ms a layer (its k/v alone: {nbytes} bytes, "
        f"{nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms at 3.35 TB/s)")
    return ms


def phase_mixers(torch, counters):
    """MIXER_SERVED at full width, random weights from seed 0 in
    ARCH_DTYPE, one model on the card at a time: ``serve_continuous`` on
    phase 5's mix through :func:`counted_serve` (every request completed,
    the pool conserved, ``paged_decode`` launches = self-attention layers
    x decode steps, ``flash_fwd`` = (self- + cross-attention layers) x
    prefills, the MoE kernels MoE layers x (decode steps + prefills); the
    cross k/v are the reference's zeros, R6), :func:`mixer_teacher`, a
    profiled decode step (host and device ms, idle share, launches), the
    recurrent archs' prefill per layer (:func:`scan_prefill_ms`) and the
    cross archs' one-token cross decode (:func:`cross_decode_ms`).  Prints
    tok/s, TTFT and peak memory of each."""
    import gc

    from repro_torch.configs import get_config
    from repro_torch.models import decoder as dec
    from repro_torch.tree import tree_leaves

    results = {}
    for arch, repeats in MIXER_SERVED:
        dname = ARCH_DTYPE[arch]
        dt = getattr(torch, dname)
        cfg = get_config(arch)
        if repeats is not None:
            cfg = dataclasses.replace(cfg, repeats=repeats)
        n = mixer_counts(cfg)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        params = dec.init_model(cfg, seed=0, device="cuda", dtype=dt)
        torch.cuda.synchronize()
        n_par = sum(t.numel() for t in tree_leaves(params))
        say("mixers", f"{arch} full width, {cfg.num_layers} layers "
            f"({', '.join(f'{s.mixer}/{s.ffn}' for s in cfg.pattern)} x "
            f"{cfg.repeats}), d_model {cfg.d_model}"
            + (f", encoder {cfg.encoder.num_layers} layers over "
               f"{cfg.encoder.frames} frames" if cfg.encoder else "")
            + (f", cross k/v {cfg.cross_kv_len}" if cfg.cross_kv_len else "")
            + f"; {n_par} {dname} parameters from seed 0 in "
            f"{time.perf_counter() - t0:.1f} s; "
            f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated")
        out, launches = counted_serve(torch, counters, cfg, params,
                                      compute_dtype=dt, phase="mixers")
        steps, pre = out["decode_steps"], out["prefills"]
        want = {"paged_decode": n["self"] * steps,
                "flash_fwd": (n["self"] + n["cross"]) * pre,
                "moe_dispatch": n["moe"] * (steps + pre),
                "moe_combine": n["moe"] * (steps + pre),
                "moe_positions": n["moe"] * (steps + pre)}
        check(all(launches[k] == want.get(k, 0) for k in counters),
              f"{arch}: launches {launches}, expected {want} ({steps} "
              f"decode steps, {pre} prefills, layers {n})")
        say("mixers", f"{arch}: launches = layers {n} x ({steps} decode "
            f"steps, {pre} prefills) = {launches}")
        peak = torch.cuda.max_memory_allocated() / 1e9
        state, teacher = mixer_teacher(torch, counters, cfg, params, dt)
        prof = phase_profile(torch, state, arch, compute_dtype=dt)
        del state
        scan = (scan_prefill_ms(torch, cfg, params, dt)
                if arch in SCAN_ARCHS else None)
        cross = cross_decode_ms(torch, cfg, params, dt) if n["cross"] else None
        ttft = [t for t in out["ttft_s"] if t is not None]
        results[arch] = {
            "dtype": dname, "layers": cfg.num_layers, "params": n_par,
            "launches": launches, "decode_steps": steps, "prefills": pre,
            "decode_tok_per_s": out["decode_tok_per_s_in_chunks"],
            "run_tok_per_s": out["decode_tok_per_s"],
            "ttft_p50_ms": statistics.median(ttft) * 1e3,
            "ttft_max_ms": max(ttft) * 1e3, "peak_gb": peak,
            "step_host_ms": prof["host_ms"],
            "step_device_ms": prof["device_ms"], "idle": prof["idle"],
            "step_launches": prof["launches"], "split_ms": prof["split_ms"],
            "teacher": teacher, "prefill_512": scan,
            "cross_decode_ms": cross}
        r = results[arch]
        say("mixers", f"{arch} ({dname}, {cfg.num_layers} layers): decode "
            f"{r['decode_tok_per_s']:.1f} tok/s in chunks, TTFT p50 "
            f"{r['ttft_p50_ms']:.1f} ms, max {r['ttft_max_ms']:.1f} ms; serve "
            f"peak memory {peak:.2f} GB; a decode step {prof['host_ms']:.2f} "
            f"ms host, {prof['device_ms']:.3f} ms device (idle "
            f"{prof['idle']:.3f}, {prof['launches']:.0f} launches)")
        del params
        gc.collect()
        torch.cuda.empty_cache()
    return results


#: phase 17's 2-layer full-width training checks: (arch, batch, tokens)
#: and how each is cut to 2 layers: whisper-large-v3 2 encoder layers
#: over its 1,500 frames and 2 decoder layers; llama-3.2-vision-11b one
#: self- and one cross-attention layer over 1,601 patches; jamba-v0.1-52b
#: one Mamba and one attention + MoE layer (its period's layers 2 and 3)
#: in bfloat16; rwkv6-7b 2 layers (no kernel: held against the CPU)
MIXER_TEACHER = (("whisper-large-v3", 2, 448), ("llama-3.2-vision-11b", 2, 512),
                 ("jamba-v0.1-52b", 1, 512), ("rwkv6-7b", 1, 64))


def two_layer_config(cfg):
    from repro_torch.models.config import EncoderConfig

    if cfg.encoder is not None:
        return dataclasses.replace(cfg, repeats=2, encoder=EncoderConfig(
            num_layers=2, frames=cfg.encoder.frames))
    if len(cfg.pattern) == 1:
        return dataclasses.replace(cfg, repeats=2)
    j = next(i for i, s in enumerate(cfg.pattern)
             if s.mixer in ("attn", "cross_attn") and i > 0
             and s.mixer != cfg.pattern[i - 1].mixer)
    return dataclasses.replace(cfg, pattern=cfg.pattern[j - 1:j + 1],
                               repeats=1)


def phase_mixer_teacher(torch, counters):
    """One ``loss_fn`` with its gradients at full width and 2 layers
    (:func:`two_layer_config`, MIXER_TEACHER), through the kernels against
    the plain versions (``attn_impl="ref"``, ``moe_impl="slot"``) on the
    card, with the stub context the data pipeline draws.  float32: the
    loss to 1e-5 relative and each gradient leaf to 1e-3 of its largest
    entry (phase 9's); jamba-v0.1-52b in bfloat16: the loss within 2^-7
    relative and the global gradient norm within 2^-5 (phase 16's OLMoE
    check); rwkv6-7b has no kernel, so its loss and gradients on the card
    are held against the same run on the CPU at the float32 tolerances.
    Launches: each attention call (encoder, self, cross) runs the flash
    forward twice (forward and remat recompute) and each backward pass
    once, each MoE kernel 3 times a layer."""
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticTokenDataset
    from repro_torch.models import decoder as dec
    from repro_torch.optim import clip_by_global_norm
    from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

    by_arch = {}
    for arch, B, S in MIXER_TEACHER:
        dt = getattr(torch, ARCH_DTYPE[arch])
        cfg = two_layer_config(get_config(arch))
        params = dec.init_model(cfg, seed=0, device="cuda", dtype=dt)
        ctx = cfg.encoder.frames if cfg.encoder else cfg.cross_kv_len
        batch = _batch_on_card(torch, SyntheticTokenDataset(
            cfg.vocab, B, S, context_len=ctx, d_model=cfg.d_model), 0)

        def value_and_grads(cfg_x, p=params, b=batch):
            leaves = [t.detach().requires_grad_(True)
                      for t in tree_leaves(p)]
            loss = dec.loss_fn(tree_unflatten(p, leaves), cfg_x, b,
                               compute_dtype=dt)
            return loss.item(), torch.autograd.grad(loss, leaves)

        n0 = {k: fn.launches for k, fn in counters.items()}
        loss_k, g_k = value_and_grads(cfg)
        n1 = {k: fn.launches for k, fn in counters.items()}
        if arch == "rwkv6-7b":
            other = "the CPU"
            loss_r, g_r = value_and_grads(
                cfg, tree_map(lambda t: t.cpu(), params),
                {k: v.cpu() for k, v in batch.items()})
            g_r = [g.to("cuda") for g in g_r]
        else:
            other = "plain versions"
            loss_r, g_r = value_and_grads(
                dataclasses.replace(cfg, attn_impl="ref", moe_impl="slot"))
        torch.cuda.synchronize()
        launched = {k: n1[k] - n0[k] for k in counters}
        check(all(fn.launches == n1[k] for k, fn in counters.items()),
              f"{arch}: the plain run launched a kernel")
        n = mixer_counts(cfg)
        calls = n["self"] + n["cross"] + (cfg.encoder.num_layers
                                          if cfg.encoder else 0)
        want = {"flash_fwd": 2 * calls, "flash_bwd_dkdv": calls,
                "flash_bwd_dq": calls, "moe_dispatch": 3 * n["moe"],
                "moe_combine": 3 * n["moe"], "moe_positions": 2 * n["moe"]}
        check(all(launched[k] == want.get(k, 0) for k in counters),
              f"{arch}: kernel launches {launched}, expected {want}")
        check(math.isfinite(loss_k) and all(bool(torch.isfinite(g).all())
                                            for g in g_k),
              f"{arch}: non-finite loss or gradient")
        dloss = abs(loss_k - loss_r)
        if dt == torch.float32:
            rel = max(((a - b).abs().max()
                       / b.abs().max().clamp_min(1e-30)).item()
                      for a, b in zip(g_k, g_r))
            check(dloss <= 1e-5 * abs(loss_r), f"{arch}: loss {loss_k} vs "
                  f"{other} {loss_r}")
            check(rel <= 1e-3, f"{arch}: a gradient leaf is off by "
                  f"{rel:.3e} of its largest entry (> 1e-3)")
            how = f"worst gradient leaf max|d| / max|g| {rel:.3e} (tol 1e-3)"
        else:
            norm_k = clip_by_global_norm(list(g_k), 1.0)[1].item()
            norm_r = clip_by_global_norm(list(g_r), 1.0)[1].item()
            rel = abs(norm_k - norm_r) / norm_r
            check(dloss <= 2 ** -7 * abs(loss_r) and rel <= 2 ** -5,
                  f"{arch} bfloat16: loss {loss_k} vs {loss_r}, grad norm "
                  f"{norm_k} vs {norm_r}")
            how = (f"grad norm {norm_k:.6f} vs {norm_r:.6f} (relative "
                   f"{rel:.3e}, tol 2^-5)")
        layers = ", ".join(f"{s.mixer}/{s.ffn}" for s in cfg.pattern) + (
            f" x {cfg.repeats}") + (f", encoder {cfg.encoder.num_layers}"
                                    if cfg.encoder else "")
        say("mixers", f"{arch} full width, 2 layers ({layers}), {B} x {S} "
            f"tokens" + (f", context {ctx}" if ctx else "") + f", "
            f"{str(dt)[6:]}: loss {loss_k:.6f} (card) vs {loss_r:.6f} "
            f"({other}), |dloss| {dloss:.3e}; {how}; kernel launches "
            f"{launched}")
        by_arch[arch] = {"launches": launched, "dloss": dloss,
                         "grad_rel": rel}
        del params, g_k, g_r, batch
        torch.cuda.empty_cache()
    return by_arch


# --------------------------------------------------------------------------
# phase 18: the multi-device layer on a 1x1 mesh over NCCL
# --------------------------------------------------------------------------

#: phase 18's runs: the 2-layer OLMoE loss (batch, sequence), the prefill
#: and decode steps (batch, prompt, cache length), the 1-stage pipeline
#: (microbatches, rows, width)
MESH_MOE = (2, 512)
MESH_SERVE = (2, 512, 1024)
MESH_PIPE = (8, 16, 2048)
#: the bound phase 18 holds a mesh run to when it is not bit-equal to the
#: unsharded one: phase 9's (the loss to 1e-5 relative, each gradient leaf
#: or logit tensor to 1e-3 of its largest entry)
MESH_LOSS_RTOL, MESH_LEAF_RTOL = 1e-5, 1e-3


def _gap(torch, a, b) -> float:
    """max|a - b| / max|b| of two tensors (a DTensor is gathered)."""
    from torch.distributed.tensor import DTensor

    a = a.full_tensor() if isinstance(a, DTensor) else a
    b = b.full_tensor() if isinstance(b, DTensor) else b
    return ((a.float() - b.float()).abs().max()
            / b.float().abs().max().clamp_min(1e-30)).item()


def _held(torch, label, pairs, rtol) -> dict:
    """Bit-equality, else the worst relative gap, of (mesh, plain) pairs;
    fails past ``rtol``."""
    equal = all(torch.equal(_plain(a), _plain(b)) for a, b in pairs)
    worst = 0.0 if equal else max(_gap(torch, a, b) for a, b in pairs)
    check(equal or worst <= rtol, f"mesh: {label} off by {worst:.3e} of its "
          f"largest entry (> {rtol})")
    return {"bit_equal": equal, "worst_rel": worst}


def _plain(t):
    from torch.distributed.tensor import DTensor

    return t.full_tensor() if isinstance(t, DTensor) else t


def mesh_train(torch, counters, mesh, train_out, train_prof):
    """Phase 8's run on the mesh: llama3.2-1b at full width and depth,
    float32, the parameters and AdamW state laid out by ``param_specs``,
    phase 8's batches placed by ``shard_batch``, three ``make_train_step``
    steps under ``use_mesh`` (the flash kernels through ``local_map``),
    then one profiled step beside phase 10's."""
    from torch.distributed.tensor import DTensor
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticTokenDataset
    from repro_torch.data.pipeline import shard_batch
    from repro_torch.launch.steps import init_train_state, make_train_step
    from repro_torch.parallel import act
    from repro_torch.parallel import sharding as shd
    from repro_torch.tree import tree_leaves

    steps, batch, seq, micro = TRAIN
    cfg = get_config("llama3.2-1b", reduced=False)
    params, opt = init_train_state(cfg, seed=0, device="cuda")
    params = shd.distribute(params, shd.param_specs(params, cfg, mesh), mesh)
    opt = shd.distribute(opt, shd.param_specs(opt, cfg, mesh), mesh)
    step = make_train_step(cfg, lr=3e-4, microbatch=micro,
                           compute_dtype=torch.float32)
    ds = SyntheticTokenDataset(cfg.vocab, batch, seq, seed=0)
    losses, gnorms, walls = [], [], []
    for fn in counters.values():
        fn.launches = 0
    with act.use_mesh(mesh):
        for i in range(steps):
            t0 = time.perf_counter()
            b = shard_batch(ds.batch(i), mesh)
            params, opt, m = step(params, opt, b)
            losses.append(m["loss"].full_tensor().item())
            gnorms.append(m["grad_norm"].full_tensor().item())
            walls.append(time.perf_counter() - t0)
    launches = {name: fn.launches for name, fn in counters.items()}
    layers, n_micro = cfg.num_layers, batch // micro
    want = {"flash_fwd": 2 * layers * n_micro,
            "flash_bwd_dkdv": layers * n_micro,
            "flash_bwd_dq": layers * n_micro}
    check(all(launches[k] == steps * want.get(k, 0) for k in counters),
          f"mesh train: launches {launches}, expected {steps} x {want}")
    leaves = tree_leaves(params) + tree_leaves(opt)
    check(all(isinstance(t, DTensor) and t.to_local().is_cuda
              for t in leaves), "mesh train: a parameter or moment left "
          "the mesh")
    equal = (losses == train_out["losses"]
             and gnorms == train_out["grad_norms"])
    worst = max(abs(a - b) / abs(b) for a, b in
                zip(losses + gnorms,
                    train_out["losses"] + train_out["grad_norms"]))
    check(equal or worst <= MESH_LOSS_RTOL, f"mesh train: losses {losses} / "
          f"grad norms {gnorms} vs phase 8's {train_out['losses']} / "
          f"{train_out['grad_norms']}")
    say("mesh", f"llama3.2-1b full width on a 1x1 (data, model) mesh over "
        f"NCCL, {steps} steps of {batch} x {seq} in microbatches of {micro}:"
        f" losses {[round(x, 6) for x in losses]}, grad norms "
        f"{[round(x, 6) for x in gnorms]}; vs phase 8: "
        + ("bit-equal" if equal else f"worst relative gap {worst:.3e}")
        + f"; launches per step flash_fwd {launches['flash_fwd'] // steps}, "
        f"flash_bwd_dkdv {launches['flash_bwd_dkdv'] // steps}, flash_bwd_dq "
        f"{launches['flash_bwd_dq'] // steps}; wall "
        f"{[round(w, 2) for w in walls]} s/step (phase 8: "
        f"{train_out['seconds'] / steps:.2f} s/step incl. its first)")

    def run(i):
        nonlocal params, opt
        with act.use_mesh(mesh):
            params, opt, m = step(params, opt, shard_batch(ds.batch(i), mesh))
            torch.cuda.synchronize()

    t0 = time.perf_counter()
    run(steps)
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run(steps + 1)
    dev_ms, split, n_launch = device_split(torch, prof, 1, "mesh train step")
    idle = 1.0 - dev_ms / wall_ms
    say("mesh", f"a sharded train step: host clock {wall_ms:.1f} ms, device "
        f"busy {dev_ms:.1f} ms, idle share {idle:.3f}, {n_launch:.0f} kernel "
        f"launches; phase 10's unsharded step: host clock "
        f"{train_prof['host_ms']:.1f} ms, device busy "
        f"{train_prof['device_ms']:.1f} ms, idle share "
        f"{train_prof['idle']:.3f}, {train_prof['launches']:.0f} launches")
    return {"launches": launches, "losses": losses, "grad_norms": gnorms,
            "bit_equal": equal, "worst_rel": worst, "wall_s": walls,
            "host_ms": wall_ms, "device_ms": dev_ms, "idle": idle,
            "kernel_launches": n_launch}


def mesh_moe(torch, counters, mesh):
    """A 2-layer full-width olmoe-1b-7b ``loss_fn`` with its gradients on
    the mesh (the MoE and flash kernels through ``local_map``) against the
    same through the kernels unsharded."""
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticTokenDataset
    from repro_torch.data.pipeline import shard_batch
    from repro_torch.models import decoder as dec
    from repro_torch.parallel import act
    from repro_torch.parallel import sharding as shd
    from repro_torch.tree import tree_leaves, tree_unflatten

    B, S = MESH_MOE
    cfg = dataclasses.replace(get_config("olmoe-1b-7b"), repeats=2)
    params = dec.init_model(cfg, seed=0, device="cuda")
    batch_np = SyntheticTokenDataset(cfg.vocab, B, S).batch(0)

    def value_and_grads(p, b):
        leaves = [t.detach().requires_grad_(True) for t in tree_leaves(p)]
        loss = dec.loss_fn(tree_unflatten(p, leaves), cfg, b,
                           compute_dtype=torch.float32)
        return loss, torch.autograd.grad(loss, leaves)

    loss_u, g_u = value_and_grads(
        params, {k: torch.from_numpy(v).cuda() for k, v in batch_np.items()})
    dparams = shd.distribute(params, shd.param_specs(params, cfg, mesh), mesh)
    for fn in counters.values():
        fn.launches = 0
    with act.use_mesh(mesh):
        loss_m, g_m = value_and_grads(dparams, shard_batch(batch_np, mesh))
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in counters.items()}
    layers = cfg.num_layers
    want = {"flash_fwd": 2 * layers, "flash_bwd_dkdv": layers,
            "flash_bwd_dq": layers, "moe_dispatch": 3 * layers,
            "moe_combine": 3 * layers, "moe_positions": 2 * layers}
    check(all(launches[k] == want.get(k, 0) for k in counters),
          f"mesh moe: launches {launches}, expected {want}")
    held_loss = _held(torch, "olmoe loss", [(loss_m, loss_u)],
                      MESH_LOSS_RTOL)
    held_grad = _held(torch, "olmoe gradients", list(zip(g_m, g_u)),
                      MESH_LEAF_RTOL)
    say("mesh", f"olmoe-1b-7b full width, 2 layers, {B} x {S}: loss "
        f"{_plain(loss_m).item():.6f} on the mesh vs "
        f"{loss_u.item():.6f} unsharded ({held_loss}); gradients "
        f"{held_grad}; launches {launches}")
    return {"launches": launches, "loss": held_loss, "grads": held_grad}


def mesh_serve(torch, counters, mesh):
    """llama3.2-1b at full width: ``make_prefill_step`` on the mesh (the
    flash forward through ``local_map``) and ``make_serve_step`` against a
    dense cache laid out by ``cache_specs`` (the new token's k/v written
    into its shard), each against the same step unsharded."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import shard_batch
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.models import decoder as dec
    from repro_torch.parallel import act
    from repro_torch.parallel import sharding as shd
    from repro_torch.tree import tree_map

    B, S, L = MESH_SERVE
    cfg = get_config("llama3.2-1b")
    params = dec.init_model(cfg, seed=0, device="cuda")
    tokens_np = np.random.default_rng(5).integers(
        0, cfg.vocab, (B, S)).astype(np.int32)
    tokens = torch.from_numpy(tokens_np).cuda()
    prefill_step, serve_step = make_prefill_step(cfg), make_serve_step(cfg)
    dparams = shd.distribute(params, shd.param_specs(params, cfg, mesh), mesh)

    with torch.no_grad():
        logits_u = prefill_step(params, {"tokens": tokens})
        for fn in counters.values():
            fn.launches = 0
        with act.use_mesh(mesh):
            logits_m = prefill_step(dparams,
                                    shard_batch({"tokens": tokens_np}, mesh))
        torch.cuda.synchronize()
        launches = {k: fn.launches for k, fn in counters.items()}
        want = {"flash_fwd": cfg.num_layers}
        check(all(launches[k] == want.get(k, 0) for k in counters),
              f"mesh prefill: launches {launches}, expected {want}")
        held_prefill = _held(torch, "prefill logits",
                             [(logits_m, logits_u)], MESH_LEAF_RTOL)

        cache = dec.init_cache(cfg, B, L, device="cuda")
        _, cache = dec.prefill(params, cfg, tokens, cache)
        mcache = tree_map(torch.clone, cache)
        tok = torch.argmax(logits_u[:, -1:, :cfg.vocab], -1).to(torch.int32)
        logits_du, cache = serve_step(params, tok, cache, S)
        dcache = shd.distribute(mcache, shd.cache_specs(
            mcache, cfg, mesh, batch_size=B), mesh)
        dtok = shd.distribute(tok, shd.batch_specs(
            {"t": tok}, mesh, batch_size=B)["t"], mesh)
        with act.use_mesh(mesh):
            logits_dm, dcache = serve_step(dparams, dtok, dcache, S)
        torch.cuda.synchronize()
    held_decode = _held(torch, "decode logits", [(logits_dm, logits_du)],
                        MESH_LEAF_RTOL)
    written = all(torch.equal(_plain(d[k])[:, :, S], c[k][:, :, S])
                  for d, c in zip(dcache, cache) for k in ("k", "v", "pos"))
    check(written, "mesh decode: the new token's cache row differs")
    say("mesh", f"llama3.2-1b full width, bfloat16 compute: prefill step of "
        f"{B} x {S} on the mesh vs unsharded {held_prefill}, flash_fwd "
        f"launches {launches['flash_fwd']}; serve step at position {S} "
        f"against a dense {L}-slot cache laid out by cache_specs "
        f"{held_decode}, the new token's k/v/pos rows equal")
    return {"launches": launches, "prefill": held_prefill,
            "decode": held_decode}


def mesh_pipeline(torch):
    """A 1-stage ``pipeline_loss`` over NCCL: its loss and gradients
    against the stage function's own, float32 on the card."""
    from repro_torch.parallel.pipeline import (make_stage_mesh,
                                               pipeline_loss,
                                               stack_stage_params)
    from repro_torch.tree import tree_leaves

    M, mb, d = MESH_PIPE
    gen = torch.Generator(device="cuda").manual_seed(7)
    w = torch.randn(d, d, generator=gen, device="cuda") * d ** -0.5
    b = torch.randn(d, generator=gen, device="cuda") * 0.1
    xs = torch.randn(M, mb, d, generator=gen, device="cuda")
    labels = torch.randn(M, mb, d, generator=gen, device="cuda")

    def stage_fn(p, x):
        return torch.tanh(x @ p["w"] + p["b"])

    def loss_fn(y, t):
        return torch.mean((y - t) ** 2)

    mesh = make_stage_mesh(1, device_type="cuda")
    params = stack_stage_params([{"w": w, "b": b}])
    leaves = [t.requires_grad_(True) for t in tree_leaves(params)]
    loss_p = pipeline_loss(stage_fn, loss_fn, params, xs, labels, mesh)
    g_p = torch.autograd.grad(loss_p, leaves)
    p0 = {"w": w.clone().requires_grad_(True),
          "b": b.clone().requires_grad_(True)}
    loss_d = torch.stack([loss_fn(stage_fn(p0, xs[m]), labels[m])
                          for m in range(M)]).mean()
    g_d = torch.autograd.grad(loss_d, [p0["b"], p0["w"]])
    gap = max(((a[0] - c).abs().max()).item() for a, c in zip(g_p, g_d))
    dloss = abs(loss_p.item() - loss_d.item())
    check(dloss <= 1e-6 and gap <= 1e-6, f"mesh pipeline: loss gap {dloss}, "
          f"gradient gap {gap}")
    say("mesh", f"1-stage pipeline_loss over NCCL, {M} microbatches of "
        f"{mb} x {d}: |dloss| {dloss:.3e}, max gradient gap {gap:.3e}")
    return {"dloss": dloss, "grad_gap": gap}


def mesh_dryrun():
    """The dry run on the card's build: llama3.2-1b on the 16x16 mesh of the
    fake backend with device type ``cuda`` — ``decode_32k`` (the dense
    cache: no kernel on its path) and ``prefill_32k`` (the flash forward's
    fake implementation and FLOP formula in the trace)."""
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import close_process_group

    recs = {}
    try:
        for shape in ("decode_32k", "prefill_32k"):
            rec = dryrun.dryrun_one("llama3.2-1b", shape, device="cuda")
            m, r, c = rec["memory"], rec["roofline"], rec["collectives"]
            say("mesh", f"dry run llama3.2-1b {shape} on {rec['mesh']} "
                f"(fake backend, cuda; per device, estimates for H100s): "
                f"arguments {m['argument_bytes'] / 2**30:.3f} GiB, peak "
                f"{m['peak_bytes_per_device'] / 2**30:.3f} GiB, "
                f"{rec['cost']['flops']:.4g} FLOPs, "
                f"{rec['cost']['bytes_accessed']:.4g} B accessed, "
                f"collectives {c['bytes_by_kind']} ({c['counts']}); terms "
                f"compute {r['compute_s']:.4g} s, memory "
                f"{r['memory_s']:.4g} s, collective {r['collective_s']:.4g}"
                f" s ({r['dominant']}); kernels in the graph "
                f"{rec['kernels']}; traced in {rec['lower_s']} s")
            recs[shape] = rec
    finally:
        close_process_group()
    check(recs["prefill_32k"]["kernels"].get("flash_fwd") == 16,
          f"dry run: the prefill graph holds "
          f"{recs['prefill_32k']['kernels']}, not 16 flash_fwd")
    return recs


def phase_mesh(torch, counters, train_out, train_prof):
    """Phase 18: the multi-device layer on the one card — a 1x1 (data,
    model) mesh over NCCL (world size 1): the sharded training, the MoE
    loss, prefill and decode, a 1-stage pipeline; then the dry run on the
    fake backend."""
    from repro_torch.launch.mesh import close_process_group, make_smoke_mesh

    mesh = make_smoke_mesh(device_type="cuda", backend="nccl")
    try:
        out = {"train": mesh_train(torch, counters, mesh, train_out,
                                   train_prof)}
        torch.cuda.empty_cache()
        out["moe"] = mesh_moe(torch, counters, mesh)
        torch.cuda.empty_cache()
        out["serve"] = mesh_serve(torch, counters, mesh)
        torch.cuda.empty_cache()
        out["pipeline"] = mesh_pipeline(torch)
    finally:
        close_process_group()
    out["dryrun"] = mesh_dryrun()
    return out


# --------------------------------------------------------------------------
# phase 19: the five examples through their ``main``, at their defaults
# --------------------------------------------------------------------------

#: the reference examples' deterministic numbers at their defaults
#: (``examples/*.py`` on the CPU, R1 patched).  The baselines' costs and
#: plans and the CTR stream's per-shard rows are recomputed from the
#: reference by ``tests/test_torch_examples_sched.py`` and
#: ``tests/test_torch_examples_ctr.py``; the rest is what the reference
#: prints.
REF_SERVE = {"generated_shape": [4, 16], "kv_bytes_per_token": 32768,
             "kv_ratio_3": 0.605, "requests": 12,
             "generated": [6, 11, 16] * 4}
REF_QUICKSTART = {"cost": 9.043678969273163, "plan": [0] + [1] * 15,
                  "k": [35, 1], "ps_cores": 1}
#: schedule_all_archs: (Greedy, Heuristic) cost per arch on make_fleet(4)
REF_ALL_ARCHS = {
    "jamba-v0.1-52b": (math.inf, math.inf),
    "rwkv6-7b": (19.25799563593336, 19.447895525561442),
    "chatglm3-6b": (14.99848027005109, 15.270624446616445),
    "olmoe-1b-7b": (18.442145611180205, 18.644602466954126),
    "gemma2-2b": (6.757309379210564, 6.879812426832078),
    "internlm2-20b": (73.36832509116523, 96.60911274623668),
    "whisper-large-v3": (3.4337844665673596, 3.49597999986666),
    "llama3.2-1b": (3.1814720977413504, 3.238976359838448),
    "qwen3-moe-30b-a3b": (131.77430924028158, math.inf),
    "llama-3.2-vision-11b": (27.491081883178815, 27.694887262251648),
}
REF_CTR = {"repins": 5, "pull_rows": [500026, 498869, 499664, 498241],
           "push_rows": [239582, 238889, 239437, 238813]}
REF_CHAOS = {"crashes": 2, "restores": 1,
             "checkpoints": [4, 9, 14, 19, 24, 29, 34, 39]}
REF_OBS_LANES = 3


def same_cost(got: float, want: float, rtol: float) -> bool:
    """Equal where infinite, within ``rtol`` elsewhere."""
    if math.isinf(want):
        return got == want
    return math.isclose(got, want, rel_tol=rtol, abs_tol=0.0)


def run_example(torch, counters, name, argv):
    """``repro_torch.examples.<name>.main(argv + --device cuda)`` in this
    process with every launch count set to 0 just before and read just
    after; its lines are printed under ``[examples]``.  Returns its
    result, the launches and the wall seconds."""
    import contextlib
    import importlib
    import io

    mod = importlib.import_module(f"repro_torch.examples.{name}")
    for fn in counters.values():
        fn.launches = 0
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        out = mod.main([*argv, "--device", "cuda"])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters.items()}
    for line in buf.getvalue().splitlines():
        say("examples", f"{name}: {line}")
    return out, launches, seconds


def check_serve_decode(out, launches):
    for arch, r in out["archs"].items():
        check(r["generated_shape"] == REF_SERVE["generated_shape"]
              and r["tokens_in_vocab"], f"serve_decode {arch}: {r}")
    p, c = out["paged"], out["continuous"]
    check(p["generated_shape"] == REF_SERVE["generated_shape"]
          and p["kv_bytes_per_token"] == REF_SERVE["kv_bytes_per_token"],
          f"serve_decode paged: {p}")
    check(c["requests"] == REF_SERVE["requests"]
          and c["generated"] == REF_SERVE["generated"]
          and round(c["kv_ratio"], 3) == REF_SERVE["kv_ratio_3"]
          and c["pool_conserved"], f"serve_decode continuous: {c}")
    for k in ("flash_fwd", "paged_decode", "moe_dispatch", "moe_combine",
              "moe_positions"):
        check(launches[k] > 0, f"serve_decode: no {k} launch: {launches}")
    rates = {a: r["decode_tok_per_s"] for a, r in out["archs"].items()}
    return (f"decode tok/s {rates}, paged {p['decode_tok_per_s']:.1f}, "
            f"continuous {c['decode_tok_per_s']:.1f}")


def check_quickstart(out, launches):
    from repro_torch.core import (SchedulingPlan, TrainingJob,
                                  default_fleet, paper_model_profiles,
                                  plan_cost)

    for name in ("Greedy", "Heuristic"):
        r = out["schedulers"][name]
        check(r["plan"] == REF_QUICKSTART["plan"]
              and same_cost(r["cost"], REF_QUICKSTART["cost"], 1e-12),
              f"quickstart {name}: {r}")
    rl = out["schedulers"]["RL-LSTM"]
    fleet, job = default_fleet(), TrainingJob()
    cost, prov = plan_cost(SchedulingPlan(tuple(rl["plan"])),
                           paper_model_profiles("CTRDNN", fleet), fleet, job)
    check(same_cost(rl["cost"], cost, 1e-9) and out["k"] == list(prov.k),
          f"quickstart RL-LSTM: {rl}, NumPy plan_cost {cost} k {prov.k}")
    check(rl["cost"] <= REF_QUICKSTART["cost"] * (1 + 1e-12),
          f"quickstart RL-LSTM cost {rl['cost']} above the baselines' "
          f"{REF_QUICKSTART['cost']}")
    t = out["train"]
    check(t["loss_decreased"] and math.isfinite(t["last_loss"]),
          f"quickstart train: {t}")
    layers, steps = 2, t["steps"]      # reduced llama3.2-1b
    want = {"flash_fwd": 2 * layers * steps,
            "flash_bwd_dkdv": layers * steps, "flash_bwd_dq": layers * steps}
    check(all(launches[k] == want.get(k, 0) for k in launches),
          f"quickstart: launches {launches}, expected {want}")
    return (f"RL {rl['rounds_per_s']:.1f} rounds/s; train "
            f"{t['seconds'] / steps:.3f} s/step, loss "
            f"{t['first_loss']:.3f} -> {t['last_loss']:.3f}")


def check_schedule_all_archs(out, launches):
    from repro_torch.core import SchedulingPlan, TrainingJob, plan_cost
    from repro_torch.core import make_fleet
    from repro_torch.examples.schedule_all_archs import FLEET_TYPES, JOB
    from repro_torch.models.profile import profile_arch

    check(set(out["archs"]) == set(REF_ALL_ARCHS),
          f"schedule_all_archs: archs {sorted(out['archs'])}")
    fleet, job = make_fleet(FLEET_TYPES), TrainingJob(**JOB)
    for arch, row in out["archs"].items():
        gr, he = REF_ALL_ARCHS[arch]
        check(same_cost(row["greedy_cost"], gr, 1e-9)
              and same_cost(row["heuristic_cost"], he, 1e-9),
              f"schedule_all_archs {arch}: Greedy {row['greedy_cost']!r}, "
              f"Heuristic {row['heuristic_cost']!r}; the reference's "
              f"{gr!r}, {he!r}")
        cost, _ = plan_cost(SchedulingPlan(tuple(row["rl_plan"])),
                            profile_arch(arch, fleet), fleet, job)
        check(same_cost(row["rl_cost"], cost, 1e-9),
              f"schedule_all_archs {arch}: RL cost {row['rl_cost']!r}, "
              f"its plan's NumPy cost {cost!r}")
    check(not any(launches.values()),
          f"schedule_all_archs: kernel launches {launches}")
    rates = [row["rl_rounds_per_s"] for row in out["archs"].values()]
    return (f"RL {min(rates):.1f}-{max(rates):.1f} rounds/s "
            f"({len(rates)} searches)")


def check_observability(out, launches):
    from repro_torch import obs

    check(out["lanes"] == REF_OBS_LANES,
          f"observability: {out['lanes']} process lanes")
    check(out["generated"] == [4, 8, 4, 4],
          f"observability: generated {out['generated']}")
    check(not obs.enabled(), "observability left instrumentation on")
    for k in ("flash_fwd", "paged_decode"):
        check(launches[k] > 0, f"observability: no {k} launch: {launches}")
    return (f"train {out['train_steps_per_sec']:.1f} steps/s; serve "
            f"{out['decode_tok_per_s']:.1f} tok/s")


def check_ctr(out, launches, vocab):
    check(out["repins"] == REF_CTR["repins"], f"ctr: {out['repins']} "
          "re-pins")
    for key in ("pull_rows", "push_rows"):
        got = [s[key] for s in out["shards"]]
        check(got == REF_CTR[key], f"ctr {key}: {got}, the reference's "
              f"{REF_CTR[key]}")
    t = out["tiers"]
    check(sum(t.values()) == vocab and 0 < t["device_rows"] <= 4096,
          f"ctr tiers {t}")
    check(out["pipeline_devices"] == 1, f"ctr: {out['pipeline_devices']}"
          " pipeline devices")
    check(launches["embedding_bag"] == out["hot_pulls"] > 0,
          f"ctr: embedding_bag launches {launches['embedding_bag']}, hot "
          f"pulls {out['hot_pulls']}")
    check(all(math.isfinite(x) for x in out["losses"]), "ctr: a loss is "
          "not finite")
    return (f"{out['s_per_step']:.4f} s/step, loss {out['first_loss']:.4f}"
            f" -> {out['last_loss']:.4f}, hot pulls {out['hot_pulls']}")


def check_chaos(out, launches):
    check(out["drift"] == 0.0 and out["calm_losses"] == out["chaos_losses"],
          f"ctr --chaos: drift {out['drift']}")
    got = {k: out[k] for k in REF_CHAOS}
    check(got == REF_CHAOS, f"ctr --chaos: {got}, the reference's "
          f"{REF_CHAOS}")
    return f"drift {out['drift']:.2e}, {out['restores']} restore"


def phase_examples(torch, counters):
    """Phase 19: each of the five examples through its ``main`` at its
    defaults on the card, then ``heterps_ctr_pipeline --chaos``, each
    with the launch counts set to 0 just before and read just after and
    its deterministic numbers held to the reference's; then the
    ``python -m`` entry of one of them as a subprocess."""
    import os

    from repro_torch.examples import heterps_ctr_pipeline as ctr

    runs = {}
    for label, name, argv, chk in (
            ("serve_decode", "serve_decode", [], check_serve_decode),
            ("quickstart", "quickstart", [], check_quickstart),
            ("schedule_all_archs", "schedule_all_archs", [],
             check_schedule_all_archs),
            ("observability", "observability", [], check_observability),
            ("heterps_ctr_pipeline", "heterps_ctr_pipeline", [],
             functools.partial(check_ctr, vocab=ctr.VOCAB)),
            ("heterps_ctr_pipeline --chaos", "heterps_ctr_pipeline",
             ["--chaos"], check_chaos)):
        out, launches, seconds = run_example(torch, counters, name, argv)
        what = chk(out, launches)
        say("examples", f"{label}: {seconds:.1f} s; launches "
            f"{ {k: n for k, n in launches.items() if n} }; {what}")
        runs[label] = {"seconds": seconds, "launches": launches}
        torch.cuda.empty_cache()

    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(SRC)] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m",
                           "repro_torch.examples.serve_decode", "--device",
                           "cuda"], cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=300)
    check(proc.returncode == 0, f"python -m repro_torch.examples."
          f"serve_decode exited {proc.returncode}:\n{proc.stderr[-3000:]}")
    lines = proc.stdout.splitlines()
    check(len(lines) == 6 and "pool-conserved=True" in lines[-1],
          f"python -m repro_torch.examples.serve_decode printed {lines}")
    say("examples", f"python -m repro_torch.examples.serve_decode --device "
        f"cuda: exit 0 in {time.perf_counter() - t0:.1f} s; {lines[-1]}")
    return runs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", metavar="NAME.cu", action="append",
                    default=[],
                    help="an earlier version of csrc/NAME.cu (repeatable): "
                         "profiled and timed in turns with the current one")
    args = ap.parse_args(argv)
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
                "moe_positions": mk.moe_positions_cuda,
                "flash_fwd": fk.flash_fwd_cuda,
                "flash_bwd_dkdv": fk.flash_bwd_dkdv_cuda,
                "flash_bwd_dq": fk.flash_bwd_dq_cuda}

    modules = dict(zip(KERNELS, (pk, mk, fk, bk)))
    libs = build_earlier(args.baseline)

    def earlier(name):
        """The block that swaps in the earlier ``name`` kernel, or None
        when ``--baseline`` gave none."""
        return (functools.partial(earlier_kernels, modules, libs)
                if name in libs else None)

    # 3. kernels against their plain versions
    worst = phase_kernels(torch, pk)
    moe_worst = phase_moe_kernels(torch, mk)
    moe_bwd = phase_moe_backward(torch, mk)
    flash_worst = phase_flash_kernels(torch, fk)
    bag_worst = phase_bag_kernels(torch, bk)

    # 4. the CLIs with their defaults (reduced llama3.2-1b, head dim 32)
    cli_launches = phase_cli(torch, counters)

    # 5.-6. llama3.2-1b, then its state is freed before olmoe's 27.7 GB
    llama_launches, state = phase_serve(torch, counters)
    phase_profile(torch, state, "llama3.2-1b")
    del state
    torch.cuda.empty_cache()

    # 7. olmoe-1b-7b
    moe_launches, state = phase_moe(torch, counters)
    moe_in_path = {}
    for what, prof in (("decode", phase_profile),
                       ("prefill", phase_prefill_profile)):
        moe_in_path[what] = prof(torch, state, "olmoe-1b-7b")
        if earlier("moe"):        # in turns: this, previous, this
            with earlier("moe")():
                prof(torch, state, "olmoe-1b-7b, previous kernels")
            prof(torch, state, "olmoe-1b-7b")
    del state
    torch.cuda.empty_cache()

    # 8.-10. training: the teacher checks and a profiled step
    train_launches, train_out, _ = phase_train(torch, counters)
    torch.cuda.empty_cache()
    teacher = phase_teacher(torch, counters)
    train_prof = phase_train_profile(torch)
    torch.cuda.empty_cache()

    # 11. CTR training over the parameter server
    ctr = phase_ctr(torch, bk)
    if earlier("embedding_bag"):  # in turns: this, previous, this
        with earlier("embedding_bag")():
            ctr_profile(torch, ctr["wall_ms"],
                        "ctr sync step, previous kernel")
        ctr_profile(torch, ctr["wall_ms"], "ctr sync step")
    torch.cuda.empty_cache()

    # 12. timing
    timing = phase_timing(torch, pk)
    moe_timing = phase_moe_timing(torch, mk, earlier("moe"))
    pos_timing = phase_positions_timing(torch, mk)
    flash_timing = phase_flash_timing(torch, fk)
    bag_timing = phase_bag_timing(torch, bk, earlier("embedding_bag"))
    torch.cuda.empty_cache()

    # 13.-14. the scheduler, and serving with the re-planning controller
    phase_sched(torch)
    replan_launches = phase_replan(torch, counters)

    # 15. the elastic PS fleet, chaos and fleet checkpoints
    t0 = time.perf_counter()
    phase_elastic(torch, {**counters,
                          "embedding_bag": bk.embedding_bag_cuda})
    elastic_step_syncs(torch)
    phase_elastic_processes(torch)
    say("elastic", f"phase 15 took {time.perf_counter() - t0:.1f} s")

    # 16. the other archs at full width, olmoe-1b-7b trained at full depth
    t0 = time.perf_counter()
    archs = phase_archs(torch, counters)
    arch_teacher = phase_teacher(torch, counters, ARCH_TEACHER_RUNS,
                                 phase="archs")
    olmoe_train = phase_olmoe_train(torch, counters)
    say("archs", f"phase 16 took {time.perf_counter() - t0:.1f} s")

    # 17. the recurrent and encoder mixers' archs at full width
    t0 = time.perf_counter()
    mixers = phase_mixers(torch, counters)
    mixer_teacher_runs = phase_mixer_teacher(torch, counters)
    say("mixers", f"phase 17 took {time.perf_counter() - t0:.1f} s")

    # 18. the multi-device layer: a 1x1 mesh over NCCL, the dry run
    t0 = time.perf_counter()
    mesh = phase_mesh(torch, counters, train_out, train_prof)
    say("mesh", f"phase 18 took {time.perf_counter() - t0:.1f} s")

    # 19. the five examples through their main, at their defaults
    t0 = time.perf_counter()
    examples = phase_examples(torch, {**counters,
                                      "embedding_bag": bk.embedding_bag_cuda})
    say("examples", f"phase 19 took {time.perf_counter() - t0:.1f} s")

    #: the main paths, each run with the counts set to 0 just before it
    #: and read just after; ``launches`` sums them
    main_paths = (("llama3.2-1b serve", llama_launches),
                  ("olmoe-1b-7b serve", moe_launches),
                  ("llama3.2-1b train", train_launches),
                  *((f"{a} serve ({r['dtype']})", r["launches"])
                    for a, r in archs.items()),
                  ("olmoe-1b-7b train, 16 layers, bfloat16",
                   olmoe_train["launches"]),
                  *((f"{a} serve ({r['dtype']}, {r['layers']} layers)",
                     r["launches"]) for a, r in mixers.items()),
                  ("llama3.2-1b train on a 1x1 mesh",
                   mesh["train"]["launches"]),
                  *((f"example {label}", r["launches"])
                    for label, r in examples.items()))
    paths = (*main_paths,
             ("llama3.2-1b serve --replan", replan_launches),
             ("olmoe-1b-7b 2-layer train check",
              teacher["olmoe-1b-7b"]["launches"]),
             *((f"{a} 2-layer train check", r["launches"])
               for a, r in arch_teacher.items()),
             *((f"{a} 2-layer train check", r["launches"])
               for a, r in mixer_teacher_runs.items()),
             ("olmoe-1b-7b 2-layer loss on a 1x1 mesh",
              mesh["moe"]["launches"]),
             ("llama3.2-1b prefill step on a 1x1 mesh",
              mesh["serve"]["launches"]),
             *cli_launches.items())
    by_path = {k: {p: n[k] for p, n in paths if n.get(k)} for k in counters}
    on_main = {k: sum(n.get(k, 0) for _, n in main_paths) for k in counters}
    kernels = [{
        "name": "paged_decode", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/paged_decode.cu",
        "replaces": "src/repro/kernels/paged_attention.py:277",
        "launches": on_main["paged_decode"],
        "launches_by_path": by_path["paged_decode"],
        "max_abs_err": worst["float32"],
        "max_abs_err_bf16": worst["bfloat16"], **timing,
    }]
    TIMED = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    for kname, line in (("moe_dispatch", 119), ("moe_combine", 170)):
        t = moe_timing[kname]
        kernels.append({
            "name": kname, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/moe.cu",
            "replaces": f"src/repro/kernels/moe.py:{line}",
            "launches": on_main[kname],
            "launches_by_path": by_path[kname],
            "max_abs_err": moe_worst[kname]["float32"],
            "max_abs_err_bf16": moe_worst[kname]["bfloat16"],
            "max_abs_err_backward": moe_bwd,
            **{k: t["decode"][k] for k in TIMED},
            "shape": "olmoe-1b-7b decode, G4 S1 E64 K8 C8 D2048",
            "prefill": {k: t["prefill"][k] for k in TIMED},
            **{f"{m}_bfloat16": {what: {k: t[f"{m} {what}"][k]
                                        for k in TIMED}
                                 for what in ("decode", "prefill")}
               for m in ("qwen3", "jamba")},
            # median / min / p90 of the cold calls and the warm time, the
            # empty-kernel floor, and the time per call in the olmoe
            # decode and prefill profiles
            "spread": t["spread"],
            "floor_ms": moe_timing["floor"]["median"],
            "in_path_ms": {what: prof["per_call"].get(kname)
                           for what, prof in moe_in_path.items()},
        })
    t = pos_timing
    kernels.append({
        "name": "moe_positions", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/moe.cu",
        "replaces": "no TPU kernel: jnp.cumsum in src/repro/nn/moe.py:76",
        "launches": on_main["moe_positions"],
        "launches_by_path": by_path["moe_positions"],
        "max_abs_err": 0,
        **{k: t["olmoe train"][k] for k in TIMED},
        "shape": "olmoe-1b-7b training, G8 S2048 K8 E64 C320, int64 ids",
        **{shape.replace(" ", "_"): {k: t[shape][k] for k in TIMED}
           for shape in ("olmoe decode", "qwen3 prefill")},
        # median / min / p90 of the cold calls and the warm time, the
        # empty-kernel floor, and the time per call in the olmoe decode
        # and prefill profiles
        "spread": {shape: t[shape]["spread"] for shape, *_ in
                   POSITIONS_TIMED},
        "floor_ms": t["floor"]["median"],
        "in_path_ms": {what: prof["per_call"].get("moe_positions")
                       for what, prof in moe_in_path.items()},
    })
    for kname in ("flash_fwd", "flash_bwd_dkdv", "flash_bwd_dq"):
        t = flash_timing[kname]
        kernels.append({
            "name": kname, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:85",
            "launches": on_main[kname],
            "launches_by_path": by_path[kname],
            "max_abs_err": flash_worst[kname]["float32"],
            "max_abs_err_bf16": flash_worst[kname]["bfloat16"],
            **{k: t["float32"][k] for k in TIMED},
            "shape": "llama3.2-1b training microbatch, B4 H32 S2048 hd64, "
                     "causal, float32",
            "bfloat16": {k: t["bfloat16"][k] for k in TIMED},
            "gemma2_prefill": flash_timing["gemma2_prefill"][kname],
            **{key: flash_timing[key][kname]
               for key, *_ in FLASH_MIXER_TIMED},
        })
        if kname != "flash_fwd":
            total = flash_timing["backward_total"]
            kernels[-1]["backward_total"] = {
                "parts": ["flash_bwd_dkdv", "flash_bwd_dq"],
                **{k: total["float32"][k] for k in TIMED},
                "bfloat16": {k: total["bfloat16"][k] for k in TIMED},
                "gemma2_prefill": flash_timing["gemma2_prefill"][
                    "backward_total"],
                **{key: flash_timing[key]["backward_total"]
                   for key, *_ in FLASH_MIXER_TIMED}}
    t = bag_timing["ctr hot-cache lookup"]
    kernels.append({
        "name": "embedding_bag", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/embedding_bag.cu",
        "replaces": "src/repro/kernels/embedding_bag.py:43",
        "launches": sum(ctr["launches"].values()) + sum(
            r["launches"]["embedding_bag"] for r in examples.values()),
        "launches_by_path": {
            **{f"ctr train_sparse_ps {m}, {CTR_STEPS} steps": n
               for m, n in ctr["launches"].items()},
            **{f"example {label}": r["launches"]["embedding_bag"]
               for label, r in examples.items()
               if r["launches"]["embedding_bag"]}},
        "max_abs_err": bag_worst["float32"],
        "max_abs_err_bf16": bag_worst["bfloat16"],
        **{k: t[k] for k in TIMED}, "shape": t["shape"] + " (CTR hot-cache "
        "lookup)",
        # median / min / p90 of the cold calls and the warm time (and the
        # earlier kernel's, with --baseline), the empty-kernel floor, and
        # the time per call in a profiled CTR sync run
        "spread": t["spread"], **({"previous": t["previous"]}
                                  if "previous" in t else {}),
        "floor_ms": bag_timing["floor"]["median"],
        "in_path_ms": ctr["in_path_ms"],
        **{label: bag_timing[label] for label in ("bench pooled",
                                                   "large pooled",
                                                   "long bags")},
    })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
