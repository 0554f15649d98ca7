"""Training cells: the window drives the port's training step,
``repro_torch.launch.steps.make_train_step``, on weights and token batches
the benchmark made from the seed.

Set-up builds one object, the step with its model and AdamW state (the
port's ``adamw_init``), and drives it through its first ``checked_steps``
steps with the window's own call and feed, on batches whose rows all
differ; those steps also warm it.  It then reads, for the judge, each
step's loss, the first gradient as the optimizer got it (its first
moment after one step, over 1 - beta1) and the change of every
parameter over the checked steps (the initial weights made again from
the seed, leaf by leaf; that reading is not counted in ``setup_s``).  The
window continues the same object, step after step, each on a fresh
batch, until ``--seconds`` have passed; ``train_samples_s`` is the
sequences of the window's steps over its wall time (synchronised).

After the window the program's state is freed and the plain reference
follows the checked steps from the same weights and batches (see
``harness.reference.loss_and_grads`` and ``adamw_ref``).

Cell parameters: ``lr``, ``weight_decay``, ``clip``, ``checked_steps``,
``trace_slice``, ``limits`` (``loss_gap``, ``grad_norm_gap``,
``update_norm_gap``).
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from harness import port, reference, traffic, weights
from harness.devtrace import SliceClock, warm_profiler
from harness.judge import gap_by_worst_leaf, verdict_checks

B1 = 0.9


def leaf_names(m: dict) -> list[str]:
    return [n for n, *_ in weights.leaf_specs(m)]


def batch(cell, seed: int, step: int, device) -> dict:
    t = torch.as_tensor(traffic.token_batch(cell.traffic, seed, step,
                                            cell.config["model"]["vocab"]),
                        device=device)
    return {"tokens": t[:, :-1], "labels": t[:, 1:]}


#: coordinates of each leaf whose first gradient is compared element by
#: element (a seeded sample; every coordinate of a smaller leaf)
SAMPLE = 1 << 20


def sample_of(t, seed: int, index: int, scale=1.0) -> np.ndarray:
    """The seeded coordinates of leaf ``t`` (float64 numpy)."""
    n = t.numel()
    if n <= SAMPLE:
        idx = torch.arange(n, device=t.device)
    else:
        idx = torch.as_tensor(traffic.rng(seed, 9000 + index).integers(
            0, n, SAMPLE), device=t.device)
    return (t.detach().reshape(-1)[idx].double() * scale).cpu().numpy()


def grad_samples(get, m: dict, seed: int, scale=1.0) -> dict:
    """The sampled coordinates of every leaf ``get(name)``."""
    return {n: sample_of(get(n), seed, i, scale)
            for i, n in enumerate(leaf_names(m))}


def grad_diffs(prog: dict, ref: dict) -> dict:
    """Per leaf, rms(prog - ref) / max(rms(ref), the median leaf's
    rms(ref)) on the sampled coordinates of the first gradient."""
    rms = {k: float(np.sqrt(np.mean(v * v))) for k, v in ref.items()}
    med = sorted(rms.values())[len(rms) // 2]
    return {k: float(np.sqrt(np.mean((prog[k] - ref[k]) ** 2)))
            / max(rms[k], med, 1e-30) for k in ref}


def change_norms(w, m: dict, seed: int, device, dtype) -> dict:
    """‖p - p0‖ of every leaf, p0 made again from the seed."""
    out = {}
    for name in leaf_names(m):
        p0 = weights.make_leaf(m, seed, name, device=device, dtype=dtype)
        p = weights.get_path(w, name).detach()
        sq = sum(float((a.float() - b.float()).pow(2).sum())
                 for a, b in zip(reference.pieces(p), reference.pieces(p0)))
        out[name] = sq ** 0.5
        del p0
    return out


def run_program(cell, seed: int, seconds: float, trace: bool, device,
                t_start: float) -> dict:
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim import adamw_init

    m = cell.config["model"]
    p = cell.params
    port.build_kernels(device)
    dtype = weights.dtype_of(m)
    w = weights.make(m, seed, device=device, dtype=dtype)
    cfg = port.arch_config(m, cell.config["name"])
    step = make_train_step(cfg, lr=p["lr"], weight_decay=p["weight_decay"],
                           clip=p["clip"], compute_dtype=dtype, remat=True,
                           microbatch=None)
    opt = adamw_init(w)
    losses, grad1 = [], None
    for k in range(p["checked_steps"]):
        w, opt, met = step(w, opt, batch(cell, seed, k, device))
        losses.append(met["loss"])
        if k == 0:
            grad1 = {n: sum(float(x.float().pow(2).sum()) for x in
                            reference.pieces(weights.get_path(opt.mu, n)))
                     ** 0.5 / (1 - B1) for n in leaf_names(m)}
            gsample = grad_samples(
                lambda n: weights.get_path(opt.mu, n), m, seed, 1 / (1 - B1))
    losses = [float(x) for x in losses]
    t_read = time.perf_counter()
    change = change_norms(w, m, seed, device, dtype)
    read_s = time.perf_counter() - t_read
    clock = None
    if trace:
        warm_profiler()
        clock = SliceClock(**p["trace_slice"])
    torch.cuda.synchronize(device) if device.type == "cuda" else None
    setup_s = time.perf_counter() - t_start - read_s
    n = 0
    t0 = time.perf_counter()
    k = p["checked_steps"]
    while True:
        if clock is not None:
            clock()
        w, opt, met = step(w, opt, batch(cell, seed, k + n, device))
        n += 1
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        if time.perf_counter() - t0 >= seconds:
            break
    wall = time.perf_counter() - t0
    last_loss = float(met["loss"])
    dtrace = clock.read() if clock is not None else None
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    B = cell.traffic["batch"]
    return {"losses": losses, "grad1": grad1, "change": change,
            "gsample": gsample, "steps": n, "samples": n * B, "wall_s": wall,
            "setup_s": setup_s, "memory_peak_bytes": peak, "trace": dtrace,
            "last_loss": last_loss, "switches": (clock.switches if clock
                                                 else [])}


def run_reference(cell, seed: int, device, *, quant=None) -> dict:
    """The plain reference over the checked steps: losses, the first
    clipped gradient's norm per leaf, and each leaf's change."""
    m = cell.config["model"]
    p = cell.params
    dtype = weights.dtype_of(m)
    w = weights.make(m, seed, device=device, dtype=dtype)
    state = {"count": 0,
             "mu": {n: torch.zeros_like(weights.get_path(w, n))
                    for n in leaf_names(m)},
             "nu": {n: torch.zeros_like(weights.get_path(w, n))
                    for n in leaf_names(m)}}
    losses, grad1 = [], None
    for k in range(p["checked_steps"]):
        b = batch(cell, seed, k, device)
        loss, grads = reference.loss_and_grads(w, m, b["tokens"],
                                               b["labels"], quant=quant)
        norms = reference.adamw_ref(w, grads, state, lr=p["lr"],
                                    weight_decay=p["weight_decay"],
                                    clip=p["clip"])
        losses.append(loss)
        if k == 0:
            grad1 = {n: float(v) for n, v in norms.items()}
            gsample = grad_samples(grads.__getitem__, m, seed,
                                   float(state["scale"]))
        del grads
    del state
    change = change_norms(w, m, seed, device, dtype)
    del w
    return {"losses": losses, "grad1": grad1, "change": change,
            "gsample": gsample}


def compare(prog: dict, ref: dict, cell) -> dict:
    """The judge's numbers: the worst step's relative loss gap, and the
    worst leaf's gaps of the first gradient's norm and of the change's
    norm.  Leaves whose reference gradient is under a thousandth of the
    median leaf's move by round-off alone and are left out of the
    change."""
    loss_gap = max(abs(a - b) / abs(b)
                   for a, b in zip(prog["losses"], ref["losses"]))
    g, g_leaf = gap_by_worst_leaf(prog["grad1"], ref["grad1"])
    vals = sorted(ref["grad1"].values())
    med = vals[len(vals) // 2]
    moving = {k for k, v in ref["grad1"].items() if v >= 1e-3 * med}
    u, u_leaf = gap_by_worst_leaf(prog["change"], ref["change"], moving)
    diffs = grad_diffs(prog["gsample"], ref["gsample"])
    srt = sorted(diffs.values())
    return {"loss_gap": loss_gap, "grad_norm_gap": g,
            "update_norm_gap": u, "grad_diff_median": srt[len(srt) // 2],
            "grad_leaf": g_leaf, "update_leaf": u_leaf,
            "grad_diffs": diffs, "left_out": sorted(set(ref["grad1"]) - moving)}


def free(device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def run(cell, *, seed: int, seconds: float, trace: bool, device,
        t_start: float) -> dict:
    prog = run_program(cell, seed, seconds, trace, device, t_start)
    free(device)
    t_check = time.perf_counter()
    ref = run_reference(cell, seed, device)
    free(device)
    got = compare(prog, ref, cell)
    checks, correct = verdict_checks(cell, got)
    B, S = cell.traffic["batch"], cell.traffic["seq_len"]
    return {
        "attempted": prog["steps"], "failed": 0,
        "setup_s": prog["setup_s"], "wall_s": prog["wall_s"],
        "memory_peak_bytes": prog["memory_peak_bytes"],
        "e2e": {"train_samples_s": prog["samples"] / prog["wall_s"]},
        "train": {"steps": prog["steps"], "samples": prog["samples"],
                  "batch": B, "seq": S},
        "trace": prog["trace"], "switches": prog["switches"], "spans": [],
        "model": cell.config["model"], "t0": None,
        "checks": checks, "correct": correct,
        "note": (f"setup {prog['setup_s']:.1f} s; {prog['steps']} steps of "
                 f"{B} x {S} in {prog['wall_s']:.3f} s; losses "
                 f"{prog['losses']} vs reference {ref['losses']}, last "
                 f"{prog['last_loss']:.4f}; worst leaves: gradient "
                 f"{got['grad_leaf']}, change {got['update_leaf']}; left out "
                 f"of the change: {got['left_out']}; reference check in "
                 f"{time.perf_counter() - t_check:.1f} s"),
    }


def calibrate(cell, seeds, seconds: float, device, fault, emit) -> None:
    """Per seed: the program's three checked steps (one window step
    after them) against the reference, and the float8 control against
    the reference; with ``fault="half_batch"`` the program's loss is taken
    over the first half of each batch only; ``"control_only"`` reads the
    control alone.  (``seconds`` is not used: no window is needed.)"""
    if fault not in (None, "half_batch", "control_only"):
        raise ValueError(f"unknown fault {fault!r}")
    from repro_torch.models import decoder as dec

    orig = dec.loss_fn
    if fault == "half_batch":
        def half(params, cfg, batch, **kw):
            n = batch["tokens"].shape[0] // 2
            return orig(params, cfg, {k: v[:n] for k, v in batch.items()},
                        **kw)

        dec.loss_fn = half
    try:
        for seed in seeds:
            t0 = time.perf_counter()
            rec = {"seed": seed, "fault": fault}
            if fault != "control_only":
                prog = run_program(cell, seed, 0.1, False, device, t0)
                free(device)
            t1 = time.perf_counter()
            ref = run_reference(cell, seed, device)
            free(device)
            t2 = time.perf_counter()
            if fault != "control_only":
                got = compare(prog, ref, cell)
                rec.update(**got, correct=verdict_checks(cell, got)[1],
                           losses=prog["losses"], ref_losses=ref["losses"],
                           program_s=t1 - t0, reference_s=t2 - t1)
            if fault in (None, "control_only"):
                ctl = run_reference(cell, seed, device, quant="fp8")
                free(device)
                rec["control"] = compare(ctl, ref, cell)
                rec["control_correct"] = verdict_checks(
                    cell, rec["control"])[1]
            emit(rec)
    finally:
        dec.loss_fn = orig
