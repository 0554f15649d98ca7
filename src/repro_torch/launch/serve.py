"""Serving launcher: batched prefill + continuous-batching KV-cache decode
(port of ``repro.launch.serve``).

Two entry points:

* :func:`serve` — fixed-batch generation: ONE forward pass prefills the
  whole prompt into the decode cache, then the decode loop generates
  tokens in chunks kept on the device (one host copy per chunk).
  ``kv_impl="paged"`` swaps the dense ring buffers for the shared page
  pool of ``kernels/paged_attention.py``.

* :func:`serve_continuous` — continuous batching over variable-length
  requests: sequences are admitted into batch slots against a host
  :class:`~repro_torch.kernels.PagePool` (per-admission exact-length
  prefill), decoded together in multi-token chunks, and evicted when
  done so their pages recycle into the pool for the next request.

On a CUDA device every attention layer's decode step launches the
hand-written paged-decode kernel (``kernels/csrc/paged_decode.cu``).
``--continuous --replan`` runs the re-planning controller
(``core/replan.py``) beside the serving loop: the RL scheduler's fused
search at start-up, then a window of serve telemetry every
``--replan-window-s`` seconds that tunes the admission policy.

  PYTHONPATH=src python -m repro_torch.launch.serve --no-reduced \\
      --continuous --device cuda
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
from collections import deque

import numpy as np
import torch

from repro_torch import obs
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.core.admission import (AdmissionPolicy, COMPLETED, OUTCOMES,
                                        PREEMPTED, REJECTED, TIMED_OUT)
from repro_torch.device import resolve_device
from repro_torch.kernels.paged_attention import PagePool
from repro_torch.models import decoder as dec
from repro_torch.models.profile import kv_read_bytes_per_token
from repro_torch.obs import trace as obs_trace


def _sync(t: torch.Tensor) -> None:
    """Wait for the device work that produces ``t``."""
    if t.is_cuda:
        torch.cuda.synchronize(t.device)


def _seeded_tokens(seed: int, stream: int, shape, vocab: int) -> np.ndarray:
    """Deterministic int32 token ids for ``(seed, stream)``."""
    rng = np.random.default_rng([seed, stream])
    return rng.integers(0, vocab, size=shape, dtype=np.int32)


def serve(arch: str, *, reduced: bool = True, batch: int = 4,
          prompt_len: int = 32, gen: int = 16, cache_len: int = 128,
          seed: int = 0, compute_dtype=torch.float32, kv_impl: str = "dense",
          page_size: int = 16, decode_chunk: int | None = None,
          temperature: float = 0.0, top_k: int = 0, top_p: float = 1.0,
          sample_seed: int | None = None, device=None, params=None,
          prompts=None) -> dict:
    """Fixed-batch serve: batched prefill + chunked decode.

    ``temperature=0`` (default) decodes greedily.  Any positive
    temperature samples every token (including the first, drawn from the
    prefill logits) through ``models.decoder.sample_logits`` with
    ``top_k``/``top_p`` truncation from a ``torch.Generator`` seeded with
    ``sample_seed`` (default: ``seed``), so a fixed seed reproduces the
    same tokens.  ``params`` (weights) and ``prompts`` (a ``(batch,
    prompt_len)`` int array) replace the seeded ones."""
    dev = resolve_device(device)
    cfg = get_config(arch, reduced=reduced)
    if cfg.kv_impl != kv_impl:
        cfg = dataclasses.replace(cfg, kv_impl=kv_impl)
    if kv_impl == "paged" and prompt_len + gen > cache_len:
        # the page pool does not ring-wrap: positions past capacity would
        # be silently dropped (the dense ring keeps a sliding window)
        raise ValueError(
            f"paged serve needs prompt_len+gen <= cache_len "
            f"({prompt_len}+{gen} > {cache_len})")
    if params is None:
        params = dec.init_model(cfg, seed=seed, device=dev)
    if prompts is None:
        prompts = _seeded_tokens(seed, 0, (batch, prompt_len), cfg.vocab)
    prompts = torch.tensor(np.asarray(prompts, np.int32), device=dev)
    if tuple(prompts.shape) != (batch, prompt_len):
        raise ValueError(f"prompts shape {tuple(prompts.shape)} != "
                         f"{(batch, prompt_len)}")

    cache = dec.init_cache(cfg, batch, cache_len, dtype=compute_dtype,
                           page_size=page_size, device=dev)
    t0 = time.perf_counter()
    with obs_trace.span("serve.prefill", "serve", batch=batch,
                        prompt_len=prompt_len):
        logits, cache = dec.prefill(params, cfg, prompts, cache,
                                    compute_dtype=compute_dtype)
        _sync(logits)
    prefill_s = time.perf_counter() - t0

    sampling = temperature > 0.0
    gen_rng = None
    if sampling:
        gen_rng = torch.Generator(device=dev)
        gen_rng.manual_seed(seed if sample_seed is None else sample_seed)
        tok = dec.sample_logits(logits[:, -1, : cfg.vocab], gen_rng,
                                temperature=temperature, top_k=top_k,
                                top_p=top_p)[:, None]
    else:
        tok = torch.argmax(logits[:, -1:, : cfg.vocab],
                           dim=-1).to(torch.int32)
    chunk = min(decode_chunk or gen, gen)
    outs = []
    t0 = time.perf_counter()
    done, idx, n_chunk = 0, prompt_len, 0
    while done < gen:
        with obs_trace.span("serve.decode_chunk", "serve", chunk=chunk,
                            n_chunk=n_chunk):
            toks, tok, cache = dec.decode_loop(
                params, cfg, tok, cache, idx, chunk,
                compute_dtype=compute_dtype, generator=gen_rng,
                temperature=temperature, top_k=top_k, top_p=top_p)
            outs.append(toks.cpu().numpy())   # one transfer per chunk
        done += chunk
        idx += chunk
        n_chunk += 1
    decode_s = time.perf_counter() - t0
    obs.REGISTRY.counter("serve.tokens").inc(batch * gen)
    out = np.concatenate(outs, axis=1)[:, :gen]

    el = torch.tensor([], dtype=compute_dtype).element_size()
    return {
        "arch": cfg.name, "batch": batch, "generated_shape": list(out.shape),
        "tokens": out.tolist(),
        "tokens_in_vocab": bool((out >= 0).all() and (out < cfg.vocab).all()),
        "prefill_s": prefill_s, "decode_s": decode_s,
        "sampling": ({"temperature": temperature, "top_k": top_k,
                      "top_p": top_p,
                      "sample_seed": seed if sample_seed is None
                      else sample_seed}
                     if sampling else None),
        "decode_tok_per_s": batch * gen / max(decode_s, 1e-9),
        "kv_impl": kv_impl,
        "device": str(dev),
        "kv_bytes_per_token": kv_read_bytes_per_token(
            cfg, prompt_len + gen, cache_len=cache_len,
            page_size=page_size if kv_impl == "paged" else None,
            bytes_per_el=el),
    }


def _default_requests(n: int = 12) -> list[tuple[int, int]]:
    """Deterministic skewed mix of (prompt_len, gen_len) requests."""
    return [(8 + (7 * i) % 25, 6 + (5 * i) % 15) for i in range(n)]


def serve_continuous(arch: str, *, reduced: bool = True,
                     requests: list[tuple[int, int]] | None = None,
                     slots: int = 4, page_size: int = 16,
                     num_pages: int | None = None,
                     max_seq_len: int | None = None, decode_chunk: int = 8,
                     seed: int = 0, compute_dtype=torch.float32,
                     arrival_s: list[float] | None = None,
                     deadlines=None,
                     admission: AdmissionPolicy | None = None,
                     preemption: bool = False, max_preemptions: int = 1,
                     watchdog_s: float | None = None,
                     max_wall_s: float | None = None,
                     clock=None, device=None, params=None,
                     prompts=None) -> dict:
    """Continuous-batching serve over variable-length requests.

    Each request ``(prompt_len, gen_len)`` is admitted into a free batch
    slot when the :class:`PagePool` can reserve its pages (prompt + gen +
    one decode chunk of slack), prefilled at its EXACT length (one
    forward, no padding), then decoded with every other live slot in
    ``decode_chunk``-token chunks whose tokens stay on the device until
    the chunk ends.  Finished sequences are evicted and their pages
    recycle.  ``num_pages`` below full slot coverage oversubscribes the
    pool: admission blocks until evictions free enough pages.

    ``arrival_s`` (one non-decreasing offset per request, seconds from
    loop start) makes the queue an open-loop arrival process: TTFT is
    arrival → prefill done, TPOT decode seconds per output token; both
    land in the ``serve.ttft_s`` / ``serve.tpot_s`` histograms.

    Overload robustness, as in the reference:

    * every request terminates in exactly one typed outcome —
      ``completed`` / ``rejected`` / ``timed_out`` / ``preempted``
      (requests whose page need exceeds the pool are rejected at
      arrival);
    * ``deadlines`` — one ``(ttft_deadline_s, total_deadline_s)`` pair
      for all requests or one pair per request, offsets from arrival
      (``None`` disables one).  The ``admission`` policy (default: an
      untuned :class:`~repro_torch.core.admission.AdmissionPolicy`)
      rejects provable misses, bounds the queue and caps decode
      concurrency; queued requests past their deadline are reaped as
      ``timed_out`` and in-flight ones past their total deadline are
      evicted with their partial output;
    * ``preemption=True`` — when the arrived head is blocked on pool
      pages, a victim slot with strictly more remaining work is
      preempted (pages released, generated tokens kept on the host) and
      later resumed by prefilling prompt + generated-so-far and feeding
      the saved next token, bit-exact against an un-preempted run;
    * ``watchdog_s`` — decode chunks slower than this emit a
      ``serve.stall`` instant and trigger a shed pass; ``max_wall_s``
      hard-stops the loop (in-flight → ``preempted``, queued →
      ``rejected``);
    * ``clock`` — injectable time source (default
      ``time.perf_counter``); a virtual clock makes deadline behaviour
      deterministic (idle waits then spin instead of sleeping).

    ``arch`` is an arch id or an :class:`ArchConfig` (a config cut in
    depth, say).  ``params`` (the model's weights) and ``prompts`` (one
    int array of length ``prompt_len`` per request) replace the seeded
    ones; tests use them to replay the reference's weights and prompts.
    """
    dev = resolve_device(device)
    cfg = get_config(arch, reduced=reduced) if isinstance(arch, str) else arch
    cfg = dataclasses.replace(cfg, kv_impl="paged")
    if params is None:
        params = dec.init_model(cfg, seed=seed, device=dev)
    if requests is None:
        requests = _default_requests()
    n_req = len(requests)
    if prompts is not None:
        if len(prompts) != n_req:
            raise ValueError(f"prompts has {len(prompts)} entries for "
                             f"{n_req} requests")
        for rid, ((plen, _), pr) in enumerate(zip(requests, prompts)):
            if np.shape(pr) != (plen,):
                raise ValueError(f"prompts[{rid}] has shape {np.shape(pr)}, "
                                 f"request {rid} has prompt_len {plen}")
    if max_seq_len is None:
        max_seq_len = max(p + g for p, g in requests) + decode_chunk
    pages_per_seq = -(-max_seq_len // page_size)
    if num_pages is None:
        num_pages = 1 + slots * pages_per_seq
    pool = PagePool(num_pages, page_size, slots, pages_per_seq)
    cache = dec.init_cache(cfg, slots, pages_per_seq * page_size,
                           dtype=compute_dtype, page_size=page_size,
                           num_pages=num_pages, device=dev)
    cache["page_table"] = torch.tensor(pool.table, device=dev)

    if arrival_s is not None:
        if len(arrival_s) != n_req:
            raise ValueError(
                f"arrival_s has {len(arrival_s)} entries for "
                f"{n_req} requests")
        for i in range(1, n_req):
            if arrival_s[i] < arrival_s[i - 1]:
                raise ValueError(
                    f"arrival_s must be non-decreasing (the admission "
                    f"queue is FIFO in arrival order) but arrival_s[{i}]="
                    f"{arrival_s[i]} < arrival_s[{i - 1}]="
                    f"{arrival_s[i - 1]} — sort requests, arrival_s and "
                    f"deadlines together by arrival time")
    if deadlines is None:
        deadlines = [(None, None)] * n_req
    elif isinstance(deadlines, tuple):
        deadlines = [deadlines] * n_req
    elif len(deadlines) != n_req:
        raise ValueError(
            f"deadlines has {len(deadlines)} entries for {n_req} requests")
    policy = admission if admission is not None else AdmissionPolicy(
        slots=slots)
    clk = clock if clock is not None else time.perf_counter
    real_time = clock is None

    pending = deque(enumerate(requests))   # not yet arrived (FIFO)
    arrived: deque = deque()               # admission queue: (rid, req)
    resume_q: deque = deque()              # preempted rids awaiting resume
    suspended: dict[int, dict] = {}        # rid -> {tok, done, rem}
    slot_req: list[list | None] = [None] * slots   # [rid, gen_remaining]
    cur_tok = np.zeros((slots, 1), np.int32)
    lengths = np.zeros(slots, np.int32)
    active = np.zeros(slots, bool)
    outputs: list[list[int]] = [[] for _ in requests]
    outcomes: list[str | None] = [None] * n_req
    outcome_detail: list[str | None] = [None] * n_req
    preempt_count = [0] * n_req
    el = torch.tensor([], dtype=compute_dtype).element_size()
    dense_equiv_len = pages_per_seq * page_size
    kv_spans: list[tuple[int, int]] = []   # (start_len, n_tokens) per slot
    toks_done = 0
    decode_steps = 0                       # decode_step calls (all slots)
    decode_s = 0.0                         # clock time inside decode chunks
    good_tokens = 0
    prefills = 0
    resumes = 0
    peak_pages = 0
    reg = obs.REGISTRY
    reg.gauge("serve.pool_pages_total").set(num_pages - 1)
    first_tok_t: list[float | None] = [None] * n_req
    ttft_s: list[float | None] = [None] * n_req
    tpot_s: list[float | None] = [None] * n_req
    total_s: list[float | None] = [None] * n_req

    def _arrival(rid: int) -> float:
        return t0 + (arrival_s[rid] if arrival_s is not None else 0.0)

    def _gauges():
        reg.gauge("serve.queue_depth").set(len(arrived) + len(resume_q))
        reg.gauge("serve.pool_pages_used").set(
            (num_pages - 1) - pool.free_pages)

    def _slack(rid: int, now: float) -> float | None:
        """Smallest remaining deadline margin (negative = missed)."""
        ttft_dl, total_dl = deadlines[rid]
        margins = []
        if ttft_dl is not None:
            # never-prefilled requests (queued reap) count queueing time
            elapsed = (ttft_s[rid] if ttft_s[rid] is not None
                       else now - _arrival(rid))
            margins.append(ttft_dl - elapsed)
        if total_dl is not None:
            margins.append(_arrival(rid) + total_dl - now)
        return min(margins) if margins else None

    def _finish_metrics(rid: int, now: float) -> None:
        slack = _slack(rid, now)
        if slack is not None:
            reg.histogram("serve.deadline_slack_s").record(slack)

    def _reject(rid: int, reason: str, detail: str | None = None) -> None:
        outcomes[rid] = REJECTED
        outcome_detail[rid] = detail if detail is not None else reason
        reg.counter("serve.rejected").inc()
        obs_trace.instant("serve.reject", "serve", rid=rid, reason=reason)

    def _timeout(rid: int, detail: str, now: float) -> None:
        outcomes[rid] = TIMED_OUT
        outcome_detail[rid] = detail
        reg.counter("serve.timed_out").inc()
        _finish_metrics(rid, now)
        obs_trace.instant("serve.timeout", "serve", rid=rid, where=detail)

    def _backlog_tokens() -> float:
        live = sum(max(0, sr[1]) for sr in slot_req if sr is not None)
        susp = sum(suspended[r]["rem"] for r in resume_q)
        return live + susp

    def drain_arrivals(now: float) -> None:
        """Move requests whose arrival time has passed into the admission
        queue, applying the bounded-queue / oversize / deadline-
        feasibility policy at the moment they arrive."""
        while pending and (now - t0) >= (
                arrival_s[pending[0][0]] if arrival_s is not None else 0.0):
            rid, (plen, g) = pending.popleft()
            need = plen + g + decode_chunk
            pages = pool.pages_for(need)
            cap = min(pool.pages_per_seq, num_pages - 1)
            if pages > cap:
                # validate NOW: waiting on an eviction can never help a
                # request the pool cannot hold even when empty
                _reject(rid, "oversize",
                        f"request {rid} needs {pages} pages for "
                        f"{need} tokens but the pool caps a sequence at "
                        f"{cap} pages (pages_per_seq="
                        f"{pool.pages_per_seq}, allocatable="
                        f"{num_pages - 1}) — raise max_seq_len/num_pages "
                        f"or shrink the request")
                continue
            backlog = _backlog_tokens() + sum(r[1][1] for r in arrived)
            reason = policy.admit_check(
                now=now, arrival=_arrival(rid), gen=g,
                ttft_deadline=deadlines[rid][0],
                total_deadline=deadlines[rid][1],
                backlog_tokens=backlog, queue_len=len(arrived))
            if reason is not None:
                _reject(rid, reason)
                continue
            arrived.append((rid, (plen, g)))

    def reap(now: float) -> None:
        """Shed queued / suspended requests whose deadline has already
        passed — they terminate ``timed_out`` instead of being admitted
        (or resumed) only to miss."""
        for q, where in ((arrived, "queued"), (resume_q, "suspended")):
            for item in list(q):
                rid = item if q is resume_q else item[0]
                ttft_dl, total_dl = deadlines[rid]
                late = ((ttft_dl is not None and ttft_s[rid] is None
                         and now > _arrival(rid) + ttft_dl)
                        or (total_dl is not None
                            and now > _arrival(rid) + total_dl))
                if late:
                    q.remove(item)
                    if q is resume_q:
                        suspended.pop(rid, None)
                    _timeout(rid, f"{where}_past_deadline", now)

    def _prefill_slot(s: int, rid: int, seq, feed_tok: int | None,
                      start_len: int, rem: int) -> None:
        """Shared admit/resume tail: prefill ``seq`` into slot ``s`` and
        mark it live.  ``feed_tok=None`` takes the argmax of the prefill
        logits (fresh admission, the TTFT edge); otherwise the saved
        next-token is fed (resume — the argmax is NOT recomputed, so the
        stream continues exactly where preemption cut it)."""
        nonlocal cache, prefills
        cache = {**cache, "page_table": torch.tensor(pool.table, device=dev)}
        sub = dec.slot_cache(cache, s)
        sub = {**sub, "length": torch.zeros(1, dtype=torch.int32, device=dev)}
        t_pre = clk()
        with obs_trace.span("serve.prefill", "serve", rid=rid, slot=s,
                            prompt_len=int(seq.shape[1])):
            lg, sub = dec.prefill(params, cfg, seq, sub,
                                  compute_dtype=compute_dtype)
            if feed_tok is None:
                cur_tok[s, 0] = int(torch.argmax(
                    lg[0, start_len - 1, : cfg.vocab]))
            else:
                _sync(lg)
                cur_tok[s, 0] = feed_tok
        policy.observe_prefill(clk() - t_pre)
        prefills += 1
        cache = dec.merge_slot_cache(cache, sub, s)
        lengths[s] = start_len
        active[s] = True
        slot_req[s] = [rid, rem]

    def _prompt(rid: int, plen: int):
        pr = (prompts[rid] if prompts is not None
              else _seeded_tokens(seed, 1000 + rid, (plen,), cfg.vocab))
        return torch.tensor(np.asarray(pr, np.int32),
                            device=dev).reshape(1, plen)

    def _try_preempt(rid: int, g: int, need: int) -> bool:
        """Free pages for the blocked head request by preempting the
        live slot with the most remaining work (strictly more than the
        head's whole generation — preemption must shorten the critical
        path, not shuffle it)."""
        victims = [(slot_req[s][1], s) for s in range(slots)
                   if slot_req[s] is not None
                   and slot_req[s][1] > g
                   and preempt_count[slot_req[s][0]] < max_preemptions]
        if not victims:
            return False
        _, v = max(victims)
        vrid = slot_req[v][0]
        freed_enough = (pool.available_pages + len(pool.owned_pages(v))
                        >= pool.pages_for(need))
        if not freed_enough:
            return False
        suspended[vrid] = {"tok": int(cur_tok[v, 0]),
                           "done": len(outputs[vrid]),
                           "rem": slot_req[v][1]}
        pool.preempt(v)
        resume_q.append(vrid)
        preempt_count[vrid] += 1
        slot_req[v] = None
        active[v] = False
        lengths[v] = 0
        reg.counter("serve.preemptions").inc()
        obs_trace.instant("serve.preempt", "serve", rid=vrid,
                          done=suspended[vrid]["done"], for_rid=rid)
        # hold the victim's pages for the head request across the
        # host-side bookkeeping — nothing else may race them away
        if not pool.reserve(need):
            raise RuntimeError(
                "preemption freed pages that reserve() cannot see")
        return True

    def admit() -> None:
        nonlocal resumes
        now = clk()
        drain_arrivals(now)
        reap(now)
        live = sum(1 for sr in slot_req if sr is not None)
        for s in range(slots):
            if slot_req[s] is not None:
                continue
            if live >= max(1, int(policy.max_concurrency)):
                break
            if resume_q:
                # resumes have strict priority: the request already spent
                # its queueing budget once
                rid = resume_q[0]
                plen, g = requests[rid]
                st = suspended[rid]
                need = plen + g + decode_chunk
                if not pool.can_admit(need):
                    break                   # wait for an eviction
                resume_q.popleft()
                del suspended[rid]
                pool.admit(s, need)
                seq = _prompt(rid, plen)
                if st["done"]:
                    emitted = torch.tensor(outputs[rid][:st["done"]],
                                           dtype=torch.int32, device=dev)
                    seq = torch.cat([seq, emitted[None]], dim=1)
                _prefill_slot(s, rid, seq, st["tok"], plen + st["done"],
                              st["rem"])
                resumes += 1
                reg.counter("serve.resumes").inc()
                obs_trace.instant("serve.resume", "serve", rid=rid,
                                  done=st["done"])
            elif arrived:
                rid, (plen, g) = arrived[0]
                need = plen + g + decode_chunk
                from_res = False
                if not pool.can_admit(need):
                    if not (preemption and _try_preempt(rid, g, need)):
                        break               # wait for an eviction
                    from_res = True
                arrived.popleft()
                ttft_dl = deadlines[rid][0]
                if (ttft_dl is not None and policy.prefill_s > 0.0
                        and now + policy.prefill_s
                        > _arrival(rid) + ttft_dl):
                    # stale: even an immediate prefill would miss TTFT
                    if from_res:
                        pool.cancel_reservation(need)
                    _timeout(rid, "stale_at_admission", now)
                    continue
                pool.admit(s, need, from_reservation=from_res)
                _prefill_slot(s, rid, _prompt(rid, plen), None, plen, g)
                # the argmax above synced the prefill: the first output
                # token exists NOW — that's the TTFT edge
                done_t = clk()
                first_tok_t[rid] = done_t
                ttft_s[rid] = done_t - _arrival(rid)
                reg.histogram("serve.ttft_s").record(max(ttft_s[rid], 0.0))
                reg.counter("serve.admissions").inc()
            else:
                break
            live += 1
        _gauges()

    def _complete(s: int, rid: int, now: float) -> None:
        nonlocal good_tokens
        pool.evict(s)                       # pages recycle into the pool
        slot_req[s] = None
        active[s] = False
        lengths[s] = 0
        reg.counter("serve.evictions").inc()
        g = requests[rid][1]
        tpot_s[rid] = (now - first_tok_t[rid]) / max(1, g)
        total_s[rid] = now - _arrival(rid)
        policy.observe_tpot(tpot_s[rid])
        reg.histogram("serve.tpot_s").record(max(tpot_s[rid], 0.0))
        outcomes[rid] = COMPLETED
        outcome_detail[rid] = None
        reg.counter("serve.completed").inc()
        ttft_dl, total_dl = deadlines[rid]
        met = ((ttft_dl is None or ttft_s[rid] <= ttft_dl)
               and (total_dl is None or total_s[rid] <= total_dl))
        if met:
            good_tokens += g
            reg.counter("serve.good_tokens").inc(g)
        _finish_metrics(rid, now)
        obs_trace.instant("serve.finish", "serve", rid=rid, gen=g)

    def _shutdown(now: float) -> None:
        """max_wall_s budget exhausted: everything still open terminates
        with a typed outcome — nothing is left hanging."""
        for s in range(slots):
            if slot_req[s] is None:
                continue
            rid = slot_req[s][0]
            pool.evict(s)
            slot_req[s] = None
            active[s] = False
            lengths[s] = 0
            outcomes[rid] = PREEMPTED
            outcome_detail[rid] = "shutdown"
        for rid in list(resume_q):
            outcomes[rid] = PREEMPTED
            outcome_detail[rid] = "shutdown"
        resume_q.clear()
        suspended.clear()
        for rid, _ in list(arrived) + list(pending):
            _reject(rid, "shutdown")
        arrived.clear()
        pending.clear()
        obs_trace.instant("serve.shutdown", "serve", at_s=now - t0)

    t0 = clk()
    admit()
    while any(active) or arrived or resume_q or pending:
        now = clk()
        if max_wall_s is not None and now - t0 > max_wall_s:
            _shutdown(now)
            break
        if not any(active):
            if not arrived and not resume_q and pending:
                # open-loop idle gap: sleep until the head arrival (a
                # virtual clock spins — the test clock advances itself)
                wait = _arrival(pending[0][0]) - clk()
                if real_time and wait > 0:
                    time.sleep(wait)
            admit()
            continue
        peak_pages = max(peak_pages, (num_pages - 1) - pool.free_pages)
        chunk_t0 = clk()
        with obs_trace.span("serve.decode_chunk", "serve",
                            live=int(active.sum()), chunk=decode_chunk):
            cache = {**cache,
                     "page_table": torch.tensor(pool.table, device=dev),
                     "active": torch.tensor(active, device=dev),
                     "length": torch.tensor(lengths, device=dev)}
            toks, ntok, cache = dec.decode_loop(
                params, cfg, torch.tensor(cur_tok, device=dev), cache, 0,
                decode_chunk, compute_dtype=compute_dtype)
            toks_h = toks.cpu().numpy()     # one transfer per chunk
        cur_tok = ntok.cpu().numpy().copy()  # writable: admit() refills
        harvest_t = clk()
        decode_steps += decode_chunk
        decode_s += harvest_t - chunk_t0
        if watchdog_s is not None and harvest_t - chunk_t0 > watchdog_s:
            # a stalled decode chunk starves every queued deadline: flag
            # it and shed the queue entries the stall made hopeless
            reg.counter("serve.stalls").inc()
            obs_trace.instant("serve.stall", "serve",
                              chunk_s=harvest_t - chunk_t0,
                              live=int(active.sum()))
            reap(harvest_t)
        for s in range(slots):
            if slot_req[s] is None:
                continue
            rid, rem = slot_req[s]
            take = min(rem, decode_chunk)
            outputs[rid].extend(int(t) for t in toks_h[s, :take])
            # byte accounting happens after the timer stops — only the
            # (start_length, tokens) span is recorded in the hot loop
            kv_spans.append((int(lengths[s]), take))
            toks_done += take
            reg.counter("serve.tokens").inc(take)
            lengths[s] += decode_chunk      # mirrors the device increment
            slot_req[s][1] = rem - decode_chunk
            if slot_req[s][1] <= 0:
                _complete(s, rid, harvest_t)
            else:
                total_dl = deadlines[rid][1]
                if (total_dl is not None
                        and harvest_t > _arrival(rid) + total_dl):
                    # past its total deadline mid-decode: keep the
                    # partial output, free the pages for live work
                    pool.evict(s)
                    slot_req[s] = None
                    active[s] = False
                    lengths[s] = 0
                    reg.counter("serve.evictions").inc()
                    _timeout(rid, "decode_past_deadline", harvest_t)
        admit()
    wall = clk() - t0
    _gauges()

    kv_bytes = sum(
        kv_read_bytes_per_token(cfg, start + i + 1,
                                cache_len=dense_equiv_len,
                                page_size=page_size, bytes_per_el=el)
        for start, n in kv_spans for i in range(n)
    )
    dense_bpt = kv_read_bytes_per_token(cfg, dense_equiv_len,
                                        cache_len=dense_equiv_len,
                                        page_size=None, bytes_per_el=el)
    ok = all(
        len(o) == g and all(0 <= t < cfg.vocab for t in o)
        for (rid, ((_, g), o)) in enumerate(zip(requests, outputs))
        if outcomes[rid] == COMPLETED
    )
    n_out = {k: sum(1 for o in outcomes if o == k) for k in OUTCOMES}
    if any(o is None for o in outcomes):
        raise RuntimeError(
            f"request without a terminal outcome: {outcomes}")
    return {
        "arch": cfg.name, "requests": n_req, "slots": slots,
        "page_size": page_size, "num_pages": num_pages,
        "device": str(dev),
        "generated": [len(o) for o in outputs],
        "tokens": outputs,
        "tokens_in_vocab": ok,
        "decode_tok_per_s": toks_done / max(wall, 1e-9),
        "decode_steps": decode_steps, "decode_s": decode_s,
        "prefills": prefills, "wall_s": wall,
        "kv_bytes_per_token_paged": kv_bytes / max(toks_done, 1),
        "kv_bytes_per_token_dense": dense_bpt,
        "peak_pages_in_use": peak_pages,
        "pool_conserved": (pool.free_pages == num_pages - 1
                           and pool.reserved_pages == 0),
        "ttft_s": ttft_s, "tpot_s": tpot_s, "total_s": total_s,
        "arrival_s": arrival_s,
        "outcomes": outcomes, "outcome_detail": outcome_detail,
        "outcome_counts": n_out,
        "preemptions": sum(preempt_count), "resumes": resumes,
        "good_tokens": good_tokens,
        "goodput_tok_per_s": good_tokens / max(wall, 1e-9),
        "admission": policy.report(),
    }


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="Serve an arch of the PyTorch/CUDA port (prints a JSON "
                    "report).")
    ap.add_argument("--arch", choices=ARCH_IDS, default="llama3.2-1b")
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="the small config of the arch (--no-reduced: the "
                         "full-width one)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; pass cpu for the "
                         "plain PyTorch path)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--kv-impl", choices=("dense", "paged"), default="dense")
    ap.add_argument("--continuous", action="store_true",
                    help="continuous-batching loop over a skewed request "
                         "mix (always paged, greedy)")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="sampling temperature (0 = greedy decode)")
    ap.add_argument("--top-k", type=int, default=0,
                    help="keep only the k highest logits (0 = off)")
    ap.add_argument("--top-p", type=float, default=1.0,
                    help="nucleus sampling mass (1.0 = off)")
    ap.add_argument("--sample-seed", type=int, default=None,
                    help="PRNG seed for sampling (default: the model "
                         "seed; fixed seed => reproducible tokens)")
    ap.add_argument("--obs-dir", default=None,
                    help="enable observability and write trace.json + "
                         "metrics.jsonl to this directory")
    ap.add_argument("--replan", action="store_true",
                    help="run the reactive re-planning controller on a "
                         "background thread while --continuous serves: "
                         "an RL search at start-up (on --device), then "
                         "windows of the serve SLO signals (TTFT/TPOT p99, "
                         "queue growth) that tune admission and re-plan on "
                         "sustained violation (enables the metric "
                         "registry)")
    ap.add_argument("--replan-window-s", type=float, default=1.0,
                    help="telemetry window span in seconds")
    ap.add_argument("--ttft-slo", type=float, default=0.0,
                    help="TTFT p99 SLO in seconds (0 = no SLO trigger)")
    ap.add_argument("--tpot-slo", type=float, default=0.0,
                    help="TPOT p99 SLO in seconds (0 = no SLO trigger)")
    ap.add_argument("--queue-bound", type=int, default=None,
                    help="admission queue depth bound (reject past it; "
                         "the --replan actuator retunes it)")
    ap.add_argument("--max-concurrency", type=int, default=None,
                    help="cap live decode slots below --batch")
    ap.add_argument("--deadline-ttft", type=float, default=None,
                    help="per-request TTFT deadline in seconds from "
                         "arrival (enables deadline-aware admission)")
    ap.add_argument("--deadline-total", type=float, default=None,
                    help="per-request total deadline in seconds from "
                         "arrival")
    ap.add_argument("--preemption", action="store_true",
                    help="preempt-and-resume when the page pool blocks "
                         "the arrived head request")
    ap.add_argument("--watchdog", type=float, default=None,
                    help="decode-chunk stall threshold in seconds "
                         "(stall => obs instant + queue shed pass)")
    return ap


def replan_controller(args, policy: AdmissionPolicy):
    """The ``--replan`` controller, wired as the reference's serve CLI
    wires it: a fused RL search (on ``args.device``) over the paper's
    CTR-DNN on its CPU + V100 fleet at start-up, then a window every
    ``--replan-window-s`` seconds that tunes ``policy``'s admission
    knobs and re-plans on sustained SLO drift."""
    from repro_torch.core.cost_model import TrainingJob
    from repro_torch.core.profiles import ctrdnn_layers
    from repro_torch.core.replan import (AdmissionActuator, ReplanConfig,
                                         ReplanController)
    from repro_torch.core.resources import default_fleet
    from repro_torch.core.schedulers.rl import RLScheduler
    from repro_torch.obs.bridge import snapshot_resources

    obs.REGISTRY.enabled = True   # the detector reads serve histograms
    rfleet = default_fleet()
    return ReplanController(
        ctrdnn_layers(), rfleet, TrainingJob(),
        RLScheduler(rounds=40, plans_per_round=16, early_stop_rounds=15,
                    chunk_rounds=10, device=args.device),
        snapshot_fn=lambda: snapshot_resources(rfleet[0]),
        config=ReplanConfig(window_s=args.replan_window_s,
                            ttft_slo_s=args.ttft_slo,
                            tpot_slo_s=args.tpot_slo),
        admission=AdmissionActuator(policy, ttft_slo_s=args.ttft_slo))


def main(argv: list[str] | None = None) -> None:
    args = build_parser().parse_args(argv)
    if args.obs_dir:
        obs.configure(run_dir=args.obs_dir)
    controller = None
    if args.continuous:
        policy = AdmissionPolicy(slots=args.batch,
                                 queue_bound=args.queue_bound,
                                 max_concurrency=args.max_concurrency)
        if args.replan:
            controller = replan_controller(args, policy)
            controller.start()
        deadlines = None
        if args.deadline_ttft is not None or args.deadline_total is not None:
            deadlines = (args.deadline_ttft, args.deadline_total)
        try:
            out = serve_continuous(args.arch, reduced=args.reduced,
                                   slots=args.batch, admission=policy,
                                   deadlines=deadlines,
                                   preemption=args.preemption,
                                   watchdog_s=args.watchdog,
                                   device=args.device)
        finally:
            if controller is not None:
                controller.stop()
        if controller is not None:
            out["replan"] = controller.report()
    else:
        out = serve(args.arch, reduced=args.reduced, batch=args.batch,
                    prompt_len=args.prompt_len, gen=args.gen,
                    kv_impl=args.kv_impl, temperature=args.temperature,
                    top_k=args.top_k, top_p=args.top_p,
                    sample_seed=args.sample_seed, device=args.device)
    if args.obs_dir:
        out["obs"] = obs.flush()
    print(json.dumps(out, indent=2))


if __name__ == "__main__":
    main()
