"""Serving cells: the window drives the port's continuous-batching entry
point, ``repro_torch.launch.serve.serve_continuous``, with the weights,
prompts and arrival times that the benchmark made from the seed.

Cell parameters (``perfbench/cells/<cell>.json``): ``slots``,
``page_size``, ``decode_chunk``; ``rate_per_s`` and ``grace_s`` for an
open-loop mix (requests arrive over the window and may finish up to
``grace_s`` after it; one that has not by then has failed), ``backlog``
for an offline one (the loop is cut at the window's end and partial
answers count); ``check_tokens`` and ``check_requests``, the served tokens
and requests the judge samples at least; ``trace_slice``: the profiled
slice, ``length_s`` long, ending ``before_end_s - length_s`` before the
arrivals end (late, so that the stall of stopping the profiler delays
few requests); ``limits``.

End-to-end numbers, on the host clock with tracing off:
``ttft_p90_ms`` (arrival to first token) and ``tpot_p90_ms`` ((completion
− first token) / (served − 1)) are nearest-rank 90th percentiles over
every request that arrived in the window, a failed one counting as
infinitely late; ``out_tok_s`` is the tokens served in the call over the
call's wall time.  The per-request edges are the program's host-clock
readings at its device syncs (the token's argmax read back, each chunk's
copy to the host): the entry point returns once, at the end, so they are
the only edges a caller can see.
"""

from __future__ import annotations

import dataclasses
import gc
import math
import time

import numpy as np
import torch

from harness import judge, port, traffic, weights
from harness.stats import nearest_rank
from harness.devtrace import SliceClock, warm_profiler


@dataclasses.dataclass
class State:
    cell: object
    model: dict
    cfg: object
    w: dict
    dtype: torch.dtype
    device: torch.device
    max_seq: int


def prepare(cell, seed: int, device) -> State:
    """Kernels, weights and the cell's config; nothing served yet."""
    m = cell.config["model"]
    port.build_kernels(device)
    dtype = weights.dtype_of(m)
    w = weights.make(m, seed, device=device, dtype=dtype)
    cfg = port.arch_config(m, cell.config["name"])
    max_p, max_g = traffic.max_lengths(cell.traffic)
    return State(cell, m, cfg, w, dtype, device,
                 max_p + max_g + cell.params["decode_chunk"])


def _serve(st: State, reqs: traffic.Requests, *, max_wall_s=None,
           clock=None) -> dict:
    from repro_torch.launch.serve import serve_continuous

    p = st.cell.params
    return serve_continuous(
        st.cfg, requests=reqs.pairs(), slots=p["slots"],
        page_size=p["page_size"], max_seq_len=st.max_seq,
        decode_chunk=p["decode_chunk"], compute_dtype=st.dtype,
        arrival_s=[float(a) for a in reqs.arrival_s],
        max_wall_s=max_wall_s, clock=clock, device=st.device,
        params=st.w, prompts=reqs.prompts)


def warm(st: State) -> None:
    """Serve the cell's longest and shortest prompts and a middle one for
    two decode chunks, at the cell's slot count and pool size."""
    mix, chunk = st.cell.traffic, st.cell.params["decode_chunk"]
    lens = sorted({mix["prompt"]["min"], mix["prompt"]["max"],
                   (mix["prompt"]["min"] + mix["prompt"]["max"]) // 2})
    r = traffic.rng(0, 3)
    reqs = traffic.Requests(
        np.array(lens), np.full(len(lens), 2 * chunk),
        np.zeros(len(lens)),
        [r.integers(0, st.model["vocab"], size=n, dtype=np.int32)
         for n in lens])
    _serve(st, reqs)
    if st.device.type == "cuda":
        torch.cuda.synchronize(st.device)


def make_requests(st: State, seed: int, seconds: float) -> traffic.Requests:
    return traffic.requests(st.cell.traffic, st.cell.params, seed, seconds,
                            st.model["vocab"])


def window(st: State, reqs: traffic.Requests, seconds: float,
           clock=None) -> tuple[dict, float]:
    """One measured window: (the entry point's result, wall seconds)."""
    p = st.cell.params
    open_loop = st.cell.traffic["kind"] == "open_loop"
    cut = seconds + p["grace_s"] if open_loop else seconds
    t0 = time.perf_counter()
    res = _serve(st, reqs, max_wall_s=cut, clock=clock)
    if st.device.type == "cuda":
        torch.cuda.synchronize(st.device)
    return res, time.perf_counter() - t0


def end_to_end(res: dict, wall_s: float) -> dict:
    ttft, tpot = [], []
    for o, t, tot, gen in zip(res["outcomes"], res["ttft_s"],
                              res["total_s"], res["generated"]):
        if o != "completed":
            ttft.append(math.inf)
            tpot.append(math.inf)
            continue
        ttft.append(t)
        tpot.append((tot - t) / max(1, gen - 1))
    return {"ttft_p90_ms": 1e3 * nearest_rank(ttft, 0.9),
            "tpot_p90_ms": 1e3 * nearest_rank(tpot, 0.9),
            "out_tok_s": sum(res["generated"]) / wall_s}


def tally(cell, res: dict) -> tuple[int, int]:
    """(attempted, failed).  Open loop: every request sent in the window,
    and those not completed by the grace's end.  Offline: the requests
    the window admitted, and those that ended for another reason than the
    window's end (a backlog is sized to outlast it)."""
    if cell.traffic["kind"] == "open_loop":
        n = len(res["outcomes"])
        return n, n - sum(o == "completed" for o in res["outcomes"])
    started = sum(t is not None for t in res["ttft_s"])
    bad = sum(o not in ("completed", None) and d != "shutdown"
              for o, d in zip(res["outcomes"], res["outcome_detail"]))
    return started, bad


def check(st: State, reqs: traffic.Requests, res: dict, seed: int, *,
          control: bool = False) -> dict:
    """Judge a sample of the completed requests against the reference."""
    picks = judge.sample_requests(res["outcomes"], reqs.prompt_lens,
                                  res["tokens"], seed,
                                  st.cell.params["check_tokens"],
                                  st.cell.params.get("check_requests", 1))
    return judge.judge_served(st.w, st.model, picks, reqs.prompts,
                              res["tokens"], device=st.device,
                              control=control)


def verdict_checks(cell, verdict: dict) -> tuple[dict, bool]:
    """Each number compared beside its limit (``limits`` of the cell, all
    upper limits), the served tokens checked beside the least the cell
    asks for, and whether all hold."""
    checks = {k: {"value": verdict.get(k), "limit": lim}
              for k, lim in cell.params["limits"].items()}
    ok = all(c["value"] is not None and c["value"] <= c["limit"]
             for c in checks.values())
    need = cell.params["check_tokens"]
    checks["checked_tokens_at_least"] = {"value": verdict["checked_tokens"],
                                         "limit": need}
    return checks, ok and verdict["checked_tokens"] >= need


def kv_gb(st: State, pages: int) -> float:
    """GB of KV cache that ``pages`` pages of the cell hold."""
    m = st.model
    per_token = (2 * m["n_layers"] * m["n_kv_heads"] * m["head_dim"]
                 * torch.tensor([], dtype=st.dtype).element_size())
    return pages * st.cell.params["page_size"] * per_token / 1e9


def free(st: State) -> None:
    st.w = None
    gc.collect()
    if st.device.type == "cuda":
        torch.cuda.empty_cache()


def run(cell, *, seed: int, seconds: float, trace: bool, device,
        t_start: float) -> dict:
    st = prepare(cell, seed, device)
    reqs = make_requests(st, seed, seconds)
    warm(st)
    clock, spans, switches = None, [], []
    if trace:
        from repro_torch import obs

        warm_profiler()
        obs.configure(enabled=True)
        obs.BUFFER.drain()
        sl = cell.params["trace_slice"]
        clock = SliceClock(seconds - sl["before_end_s"], sl["length_s"])
    setup_s = time.perf_counter() - t_start
    res, wall_s = window(st, reqs, seconds, clock)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    dtrace = None
    if trace:
        from repro_torch import obs

        obs.configure(enabled=False)
        spans = [e for e in obs.BUFFER.drain() if e.get("ph") == "X"]
        dtrace = clock.read()
        switches = clock.switches
    completed = sum(o == "completed" for o in res["outcomes"])
    attempted, failed = tally(cell, res)
    out = {
        "attempted": attempted, "failed": failed,
        "setup_s": setup_s, "wall_s": wall_s, "memory_peak_bytes": peak,
        "e2e": end_to_end(res, wall_s), "result": res, "requests": reqs,
        "spans": spans, "trace": dtrace, "model": st.model,
        "switches": switches, "t0": clock.t0 if trace else None,
        "note": (f"setup {setup_s:.1f} s; "
                 f"requests: {len(reqs)} sent, {completed} completed, "
                 f"{res['outcome_counts']} by outcome; "
                 f"{sum(res['generated'])} tokens served in {wall_s:.3f} s; "
                 f"decode {1e3 * res['decode_s'] / max(1, res['decode_steps']):.2f}"
                 f" ms a step; KV pages in use at peak "
                 f"{res['peak_pages_in_use']} of {res['num_pages'] - 1} "
                 f"({kv_gb(st, res['peak_pages_in_use']):.2f} of "
                 f"{kv_gb(st, res['num_pages'] - 1):.2f} GB)"
                 + ("; profiler switches took "
                    f"{[round((b - a) / 1e6, 3) for a, b in switches]} s"
                    if trace else "")),
    }
    # the program's state is gone with the entry point's return; the
    # reference runs on the weights alone
    t_check = time.perf_counter()
    verdict = check(st, reqs, res, seed)
    out["note"] += (f"; reference check of {verdict['checked_requests']} "
                    f"requests in {time.perf_counter() - t_check:.1f} s")
    out["checks"], out["correct"] = verdict_checks(cell, verdict)
    free(st)
    return out


def alter_served_tokens():
    """Plant the fault 'a token altered where it is produced': the second
    token of every slot in every decode chunk is replaced by the next id.
    Returns what undoes it."""
    from repro_torch.models import decoder as dec

    orig = dec.decode_loop

    def altered(params, cfg, token, cache, index, steps, **kw):
        toks, ntok, cache = orig(params, cfg, token, cache, index, steps,
                                 **kw)
        toks = toks.clone()
        toks[:, 1] = (toks[:, 1] + 1) % cfg.vocab
        return toks, ntok, cache

    dec.decode_loop = altered
    return lambda: setattr(dec, "decode_loop", orig)


def calibrate(cell, seeds, seconds: float, device, fault, emit) -> None:
    """Per seed, a whole window at the cell's load and the judge's
    numbers for the program and, with no fault, for its control (the
    plain reference in float8 in the program's place) on the same sampled
    tokens, judged by the same limits; ``fault="altered_token"`` plants
    that fault in the decode loop."""
    if fault not in (None, "altered_token"):
        raise ValueError(f"unknown fault {fault!r}")
    undo = alter_served_tokens() if fault == "altered_token" else None
    try:
        for seed in seeds:
            t0 = time.perf_counter()
            st = prepare(cell, seed, device)
            warm(st)
            reqs = make_requests(st, seed, seconds)
            res, wall = window(st, reqs, seconds)
            t1 = time.perf_counter()
            v = check(st, reqs, res, seed, control=fault is None)
            v["correct"] = verdict_checks(cell, v)[1]
            if fault is None:
                v["control_correct"] = verdict_checks(cell, {
                    **v, **{k[len("control_"):]: x for k, x in v.items()
                            if k.startswith("control_")}})[1]
            emit({"seed": seed, "fault": fault, **v, "requests": len(reqs),
                  "completed": sum(o == "completed"
                                   for o in res["outcomes"]),
                  **end_to_end(res, wall), "setup_and_window_s": t1 - t0,
                  "check_s": time.perf_counter() - t1})
            free(st)
    finally:
        if undo is not None:
            undo()
