"""What the per-layer metric files share: the program's spans
(``serve.prefill`` with its ``rid``, ``serve.decode_chunk``), its result
lists, and the device trace of the traced slice.  Each reader returns
None where its run holds nothing to read; a share of a roofline or of a
peak is never made up as 0.

``ctx`` carries ``cell``, ``model``, ``result`` (the entry point's return
value, serving), ``requests``, ``spans``, ``trace`` (a
:class:`harness.devtrace.DeviceTrace` or None), ``wall_s`` and, for
training, ``train`` (steps and samples of the window).
"""

from __future__ import annotations

import math
import re

from harness import flops
from harness.stats import nearest_rank

KERNELS = {
    "flash_fwd": ("fwd_kernel",),
    "flash_bwd": ("delta_kernel", "dkdv_kernel", "dq_kernel"),
    "moe": ("dispatch_kernel", "combine_kernel"),
    "paged_decode": ("paged_decode_kernel", "paged_decode_combine"),
}


def is_kernel(op_name: str, base: str) -> bool:
    """The port's kernel ``base`` (a template instance ``base<...>``)."""
    return re.search(rf"(?<![A-Za-z0-9_]){base}<", op_name) is not None


def el_bytes(m: dict) -> int:
    return {"bfloat16": 2, "float16": 2, "float32": 4}[m["dtype"]]


def held(ctx, a_us: float, b_us: float) -> bool:
    """Whether [a, b] overlaps an interval in which switching the
    profiler held the loop up (tracing's own cost, not the program's)."""
    return any(a_us < y and x < b_us for x, y in ctx.switches)


def spans(ctx, name: str) -> list[dict]:
    """The program's spans ``name``, less those the profiler held up."""
    return [s for s in ctx.spans if s["name"] == name
            and not held(ctx, s["ts"], s["ts"] + s["dur"])]


def prefill_by_rid(ctx, *, all_spans: bool = False) -> dict[int, dict]:
    src = ([s for s in ctx.spans if s["name"] == "serve.prefill"]
           if all_spans else spans(ctx, "serve.prefill"))
    return {s["args"]["rid"]: s for s in src}


def queue_wait_p90_ms(ctx):
    """Per request, arrival to first token less its own prefill span;
    requests whose first token came after the profiler was first held up
    are left out (the stop's stall delays the queue behind it), a request
    that never completed counts as infinitely late."""
    pre = prefill_by_rid(ctx, all_spans=True)
    if not pre:
        return None
    res = ctx.result
    waits = []
    for rid, t in enumerate(res["ttft_s"]):
        if t is None or rid not in pre or res["outcomes"][rid] != "completed":
            waits.append(math.inf)
            continue
        if ctx.switches:
            a = 1e6 * (ctx.t0 + res["arrival_s"][rid])
            if a + 1e6 * t > ctx.switches[-1][0] or held(ctx, a, a + 1e6 * t):
                continue
        waits.append(t - pre[rid]["dur"] / 1e6)
    return 1e3 * nearest_rank(waits, 0.9)


def prefill_ms_per_ktok(ctx):
    pre = spans(ctx, "serve.prefill")
    toks = sum(s["args"]["prompt_len"] for s in pre)
    if not toks:
        return None
    return sum(s["dur"] for s in pre) / 1e3 / (toks / 1e3)


def decode_step_ms(ctx):
    """Host ms per decode step: the decode chunks' spans over their
    steps."""
    ch = spans(ctx, "serve.decode_chunk")
    steps = sum(s["args"]["chunk"] for s in ch)
    if not steps:
        return None
    return sum(s["dur"] for s in ch) / 1e3 / steps


def _peak(m):
    return flops.PEAK_FLOPS[m["dtype"]]


def generated_flops(ctx) -> float:
    m, r = ctx.model, ctx.result
    return sum(flops.generated_flops(m, int(p), g)
               for p, g in zip(ctx.requests.prompt_lens, r["generated"]))


def _unheld_us(ctx, s) -> float:
    a, b = s["ts"], s["ts"] + s["dur"]
    return (b - a) - sum(max(0.0, min(b, y) - max(a, x))
                         for x, y in ctx.switches)


def step_mfu_decode(ctx):
    """Model FLOPs of the decoded tokens over the time in decode chunks
    (less the time the profiler's switches held them up)."""
    t = sum(_unheld_us(ctx, s) for s in ctx.spans
            if s["name"] == "serve.decode_chunk") / 1e6
    if t <= 0:
        return None
    return 100.0 * generated_flops(ctx) / t / _peak(ctx.model)


def step_mfu_prefill(ctx):
    """Model FLOPs of the prefills over the time in prefill spans."""
    pre = spans(ctx, "serve.prefill")
    t = sum(s["dur"] for s in pre) / 1e6
    if t <= 0:
        return None
    f = sum(flops.prefill_flops(ctx.model, s["args"]["prompt_len"])
            for s in pre)
    return 100.0 * f / t / _peak(ctx.model)


def step_mfu_window(ctx):
    """Model FLOPs of every prompt and output token over the window."""
    m, r = ctx.model, ctx.result
    pre = sum(flops.prefill_flops(m, int(p))
              for p, t in zip(ctx.requests.prompt_lens, r["ttft_s"])
              if t is not None)
    held_s = sum(y - x for x, y in ctx.switches) / 1e6
    return (100.0 * (pre + generated_flops(ctx)) / (ctx.wall_s - held_s)
            / _peak(m))


def device_idle_pct(ctx):
    t = ctx.trace
    if t is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s() / t.window_s)


def _roofline(ctx, kernel: str, work_of_span):
    """Σ bound / Σ device time of ``kernel``'s calls launched inside the
    spans the traced slice covers; ``work_of_span(span, op)`` gives an
    op's (FLOPs, bytes) or None to skip the span."""
    t = ctx.trace
    if t is None or not t.aligned:
        return None
    bound = took = 0.0
    for s in ctx.spans:
        if not t.covers(s):
            continue
        for op in t.ops_in(s, KERNELS[kernel]):
            if not any(is_kernel(op.name, b) for b in KERNELS[kernel]):
                continue
            w = work_of_span(s, op)
            if w is None:
                continue
            bound += flops.bound_s(*w, dtype=ctx.model["dtype"])
            took += op.dur / 1e6
    if took <= 0:
        return None
    return 100.0 * bound / took


def roofline_moe(ctx):
    m = ctx.model
    K, D, el = m["top_k"], m["d_model"], el_bytes(m)
    slots = ctx.cell.params["slots"]

    def work(span, op):
        if span["name"] == "serve.prefill":
            n = span["args"]["prompt_len"]
        elif span["name"] == "serve.decode_chunk":
            n = slots
        else:
            return None
        if is_kernel(op.name, "dispatch_kernel"):
            return flops.moe_dispatch_work(n, K, D, el)
        return flops.moe_combine_work(n, K, D, el)

    return _roofline(ctx, "moe", work)


def roofline_flash_fwd(ctx):
    m = ctx.model

    def work(span, op):
        if span["name"] != "serve.prefill":
            return None
        return flops.flash_fwd_work(1, m["n_heads"], span["args"]["prompt_len"],
                                    m["head_dim"], el_bytes(m))

    return _roofline(ctx, "flash_fwd", work)


def chunk_keys(ctx) -> dict[int, list[list[int]]]:
    """For each decode chunk span (by its index among them), the keys each
    slot attends at each of its steps: a live request decodes its chunks
    in the chunks that follow its prefill, from its prompt length on;
    a free slot reads one key."""
    chunks = sorted(spans(ctx, "serve.decode_chunk"), key=lambda s: s["ts"])
    starts = [c["ts"] for c in chunks]
    step = ctx.cell.params["decode_chunk"]
    slots = ctx.cell.params["slots"]
    live: list[list[int]] = [[] for _ in chunks]
    pre = prefill_by_rid(ctx)
    for rid, s in pre.items():
        end = s["ts"] + s["dur"]
        j0 = next((j for j, t in enumerate(starts) if t >= end), None)
        if j0 is None:
            continue
        n = -(-ctx.result["generated"][rid] // step)
        plen = int(ctx.requests.prompt_lens[rid])
        for c in range(n):
            if j0 + c < len(chunks):
                live[j0 + c].append(plen + step * c)
    out = {}
    for j, starts_j in enumerate(live):
        pad = [0] * max(0, slots - len(starts_j))
        out[j] = [[p + i + 1 for p in starts_j] + [1 for _ in pad]
                  for i in range(step)]
    return out


def roofline_paged_decode(ctx):
    """Bound of every decode-attention call in the covered chunks (one per
    layer and step) over both paged-decode kernels' time there."""
    t = ctx.trace
    if t is None or not t.aligned:
        return None
    m = ctx.model
    el = el_bytes(m)
    page = ctx.cell.params["page_size"]
    keys = chunk_keys(ctx)
    chunks = sorted(spans(ctx, "serve.decode_chunk"), key=lambda s: s["ts"])
    bound = took = 0.0
    for j, s in enumerate(chunks):
        if not t.covers(s):
            continue
        ops = [o for o in t.ops_in(s, KERNELS["paged_decode"])
               if any(is_kernel(o.name, b) for b in KERNELS["paged_decode"])]
        if not ops:
            continue
        for ks in keys[j]:
            w = flops.paged_decode_work(ks, m["n_heads"], m["n_kv_heads"],
                                        m["head_dim"], el, page)
            bound += m["n_layers"] * flops.bound_s(*w, dtype=m["dtype"])
        took += sum(o.dur for o in ops) / 1e6
    if took <= 0:
        return None
    return 100.0 * bound / took


def step_mfu_train(ctx):
    """Forward and backward model FLOPs of the window's sequences over
    the window (less the profiler's switches), as a share of the peak."""
    tr = ctx.train
    held_s = sum(y - x for x, y in ctx.switches) / 1e6
    f = tr["steps"] * flops.train_flops(ctx.model, tr["batch"], tr["seq"])
    return 100.0 * f / (ctx.wall_s - held_s) / _peak(ctx.model)


def roofline_flash_bwd(ctx):
    """Bound of the flash backward calls (one per layer and step: delta,
    dK/dV and dQ kernels) in the traced slice over those kernels' time."""
    t = ctx.trace
    if t is None:
        return None
    m, tr = ctx.model, ctx.train
    ops = [o for o in t.ops if any(is_kernel(o.name, b)
                                   for b in KERNELS["flash_bwd"])]
    calls = min(sum(is_kernel(o.name, "dkdv_kernel") for o in ops),
                sum(is_kernel(o.name, "dq_kernel") for o in ops))
    took = sum(o.dur for o in ops) / 1e6
    if not calls or took <= 0:
        return None
    w = flops.flash_bwd_work(tr["batch"], m["n_heads"], tr["seq"],
                             m["head_dim"], el_bytes(m))
    return 100.0 * calls * flops.bound_s(*w, dtype=m["dtype"]) / took
