"""CTR cells: the window drives the port's CTR training over parameter-
server shards, ``repro_torch.ps.workload.train_ctr_ps`` (the loop behind
``train --sparse-ps``), on a table, a tower and click batches the
benchmark made from the seed.

The program's loop draws its batches from ``click_stream(cfg)`` and its
step from ``make_step_fn(cfg)``, both looked up in its module when it is
called.  For the length of each call the benchmark puts its own batch
stream (``harness.traffic.ClickStream``) in the first place and, in the
second, the program's own step function wrapped so that the benchmark
sees each tower it returns and can call the trace's clock between steps
on the loop's thread.  Nothing else of the program is replaced.

Set-up makes the table (``N(0, 1) · init_scale``) and the tower on the
card from the seed, hands the table's host copy to the program's
``make_table`` (shards in processes of their own, the hot cache and its
slot map on the card) and the tower to ``train_ctr_ps``, then drives that
one table through ``checked_steps`` synchronous steps (``mode="sync"``,
re-pinning every ``checked_repin_interval`` steps, so that the last
checked pulls go through the hot cache); those steps also warm the path.
It then reads the table back (``to_dense``; not counted in ``setup_s``).

The window continues the same table and the checked steps' tower through
the asynchronous loop (``PSClient``, ``depth``), re-pinning every
``repin_interval`` steps, until ``--seconds`` have passed and then to the
end of the current period of ``repin_interval`` steps, so that each run
holds whole periods.  The end-to-end rate is the examples of the window's
steps over its wall time.

After the window: every batch drawn was trained on, every step's push
was applied (the table's push telemetry counts one push per step), every
cached row equals the shards' row bit for bit (the write-through
guarantee), every loss is finite.  The window's timed path is judged
itself, twice.  Its pushes: SGD pushes add up, so whatever the threads'
staleness, the table after the window (read back once it has closed)
less the table after the checked steps has to be, row by row,
``-lr · emb_lr_scale · Σ`` of the row gradients that the window's steps
returned at their batches' ids (``ctr_reference.push_sum``), and no
other row may change.  Its steps: for ``SAMPLED`` window steps drawn
from the seed among the first period's, the wrapped step function
keeps what it got (tower, pulled rows, labels) and gave, and the plain
reference's step on the same inputs is compared with it: loss, the
tower's change by the worst leaf, the row gradients by the worst row.
Then the program's state is freed and the plain reference
(``harness.ctr_reference``) follows the checked steps from the same
weights and batches.

Cell parameters: ``shards``, ``transport``, ``partition``, ``depth``,
``repin_interval``, ``checked_steps``, ``checked_repin_interval``,
``trace_slice``, ``limits``.
"""

from __future__ import annotations

import contextlib
import gc
import sys
import time

import numpy as np
import torch

from harness import ctr_reference, port, traffic  # noqa: F401  (port: src/ on the path)
from harness.devtrace import SliceClock, warm_profiler
from harness.judge import gap_by_worst_leaf, verdict_checks

#: the push that the planted fault ``dropped_push`` leaves out (counted
#: from the first checked step's, so it falls in the window)
DROP_AT = 13
#: the window's push (counted from its first) that ``zeroed_push`` and
#: ``misrouted_push`` spoil
SPOIL_AT = 5
#: the window steps the reference runs again
SAMPLED = 3


def log(t_start: float, what: str) -> None:
    """A line on standard error: the seconds since ``t_start`` and what
    was done by then (where a run's set-up and check go)."""
    print(f"ctr: {time.perf_counter() - t_start:8.2f} s {what}",
          file=sys.stderr, flush=True)


def ctr_config(cell):
    from repro_torch.ps.workload import CTRConfig

    c = cell.config["ctr"]
    if c["activation"] != "tanh" or c["dtype"] != "float32":
        raise ValueError("the port's CTR tower is float32 with tanh")
    return CTRConfig(vocab=c["vocab"], emb_dim=c["emb_dim"], slots=c["slots"],
                     tower=tuple(c["tower"]), batch=cell.traffic["batch"],
                     lr=c["lr"], emb_lr_scale=c["emb_lr_scale"])


class Steps:
    """The program's step function as the benchmark wraps it: calls
    ``clock`` before each step; before ``window`` is set keeps each tower
    it returns, after it each step's row gradients, and for the window
    steps in ``sample`` all that the step got and gave (``kept``)."""

    def __init__(self):
        self.towers: list[dict] = []
        self.grads: list[torch.Tensor] = []
        self.kept: dict[int, tuple] = {}
        self.sample: frozenset[int] = frozenset()
        self.window = False
        self.clock = None
        self.count = 0

    def wrap(self, make_step_fn):
        def make(cfg):
            inner = make_step_fn(cfg)

            def step(tower, emb, labels):
                if self.clock is not None:
                    self.clock()
                out = inner(tower, emb, labels)
                self.count += 1
                if not self.window:
                    self.towers.append(out[0])
                    return out
                j = len(self.grads)
                self.grads.append(out[1])
                if j in self.sample:
                    self.kept[j] = (tower, emb, labels, out)
                return out
            return step
        return make


@contextlib.contextmanager
def feeding(batches, steps: Steps):
    """Inside, ``train_ctr_ps`` draws its batches from ``batches`` and its
    step from the program's ``make_step_fn`` wrapped by ``steps``."""
    from repro_torch.ps import workload

    stream, make = workload.click_stream, workload.make_step_fn
    workload.click_stream = lambda cfg: iter(batches)
    workload.make_step_fn = steps.wrap(make)
    try:
        yield
    finally:
        workload.click_stream, workload.make_step_fn = stream, make


class Window:
    """The window's batches: step ``first + j`` of the seed's stream for
    j = 0, 1, …, ending before a ``j`` that is a multiple of ``period``
    once ``seconds`` have passed since ``t0`` (set when the window
    starts), each kept in ``batches``.  The program's loader draws them
    on a thread of its own, where an error would only end the stream: it
    is kept in ``error``."""

    def __init__(self, stream, first: int, seconds: float, period: int):
        self.stream, self.first = stream, first
        self.seconds, self.period = seconds, period
        self.t0 = None
        self.drawn = 0
        self.batches: list[dict] = []
        self.error = None

    def __iter__(self):
        j = 0
        try:
            while not (j and j % self.period == 0
                       and time.perf_counter() - self.t0 >= self.seconds):
                self.batches.append(self.stream.batch(self.first + j))
                yield self.batches[-1]
                j += 1
                self.drawn = j
        except Exception as e:
            self.error = e
            raise


def telemetry(table) -> dict:
    """The table's push and pull counters, shard by shard."""
    t = table.telemetry
    return {"push_ops": [c.ops for c in t.push],
            "push_s": [c.seconds for c in t.push],
            "pull_rows": [c.rows for c in t.pull],
            "pull_hot_rows": [c.hot_rows for c in t.pull]}


def telemetry_delta(a: dict, b: dict) -> dict:
    d = {k: [y - x for x, y in zip(a[k], b[k])] for k in a}
    return {"pushes": max(d["push_ops"]), "push_s": max(d["push_s"]),
            "pull_rows": sum(d["pull_rows"]),
            "pull_hot_rows": sum(d["pull_hot_rows"])}


def _bits(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a).view(np.uint32)


def stray_rows(before: np.ndarray, after: np.ndarray,
               touched: np.ndarray) -> int:
    """Rows outside ``touched`` (sorted ids) that changed in any bit."""
    changed = np.flatnonzero((_bits(after) != _bits(before)).any(axis=1))
    return int(np.setdiff1d(changed, touched).size)


def checked_rows(table, table0: torch.Tensor, ids: np.ndarray) -> dict:
    """After the checked steps: the table read back (``table``), the rows
    the steps touched, each one's change (float64), and how many other
    rows changed at all."""
    now = table.to_dense().numpy()
    before = table0.numpy()
    touched = np.unique(ids)
    return {"table": now, "touched": touched,
            "row_change": now[touched].astype(np.float64)
            - before[touched].astype(np.float64),
            "stray_rows": stray_rows(before, now, touched)}


def hot_rows_differing(table, shards: np.ndarray) -> tuple[int, int]:
    """(cached rows whose copy on the card differs from the shards' row
    (``shards``, the table read back) in any bit, cached rows)."""
    slot = table.slot_of[:-1]
    ids = torch.nonzero(slot >= 0).flatten()
    if ids.numel() == 0:
        return 0, 0
    hot = table.hot_rows[slot[ids].long()].cpu().numpy()
    rows = shards[ids.cpu().numpy()]
    return int((_bits(hot) != _bits(rows)).any(axis=1).sum()), ids.numel()


def window_sample(seed: int, p: dict) -> frozenset[int]:
    """The window steps whose inputs and outputs are kept for the
    reference: ``SAMPLED`` of the first period's, drawn from the seed
    (every window holds a whole period)."""
    n = min(SAMPLED, p["repin_interval"])
    return frozenset(int(j) for j in traffic.rng(seed, 7000).choice(
        p["repin_interval"], size=n, replace=False))


def tower_norms(towers: list[dict], c: dict) -> tuple[dict, dict]:
    """Per tower leaf: the first gradient as SGD applied it, ‖p1 − p0‖ /
    lr, and the change over the checked steps, ‖pk − p0‖ (float64)."""
    names = ctr_reference.leaf_names(c)
    p0, p1, pk = (ctr_reference.leaves(t) for t in
                  (towers[0], towers[1], towers[-1]))

    def norm(a, b):
        return float((a.double() - b.double()).norm())

    return ({n: norm(a, b) / c["lr"] for n, a, b in zip(names, p0, p1)},
            {n: norm(a, b) for n, a, b in zip(names, p0, pk)})


def free(device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def build_kernels(device) -> None:
    """The embedding-bag kernel the hot cache gathers with (built on a
    checkout's first run, found in its build directory after)."""
    if device.type != "cuda":
        return
    from repro_torch.kernels import _build

    _build.build_all(("embedding_bag",))
    _build.load("embedding_bag")


def run_program(cell, seed: int, seconds: float, trace: bool, device,
                t_start: float) -> dict:
    from repro_torch.ps import workload

    c, p = cell.config["ctr"], cell.params
    build_kernels(device)
    cfg = ctr_config(cell)
    stream = traffic.ClickStream(cell.traffic, c["cardinalities"], seed)
    k = p["checked_steps"]
    batches = [stream.batch(i) for i in range(k)]
    table0 = ctr_reference.init_table(c, seed, device).cpu()
    free(device)
    tower0 = ctr_reference.init_tower(c, seed, device)
    log(t_start, "kernels, click stream, table and tower made")
    table = workload.make_table(cfg, p["shards"], partition=p["partition"],
                                transport=p["transport"], device=device,
                                dense=table0)
    log(t_start, f"{p['shards']} shards hold the table")
    try:
        steps = Steps()
        with feeding(batches, steps):
            res = workload.train_ctr_ps(
                cfg, steps=k, mode="sync", num_shards=p["shards"],
                repin_interval=p["checked_repin_interval"], table=table,
                tower=tower0, device=device)
        _sync(device)
        log(t_start, f"{k} checked steps ({res['repins']} re-pins)")
        t_read = time.perf_counter()
        rows = checked_rows(table, table0,
                            np.concatenate([b["ids"].ravel()
                                            for b in batches]))
        table1 = rows.pop("table")
        del table0
        gc.collect()
        read_s = time.perf_counter() - t_read
        log(t_start, "table read back")
        checked = {"losses": res["losses"],
                   "towers": [tower0, *steps.towers], **rows}
        clock = None
        if trace:
            warm_profiler()
            clock = SliceClock(**p["trace_slice"])
        before = telemetry(table)
        window = Window(stream, k, seconds, p["repin_interval"])
        steps.window, steps.clock = True, clock
        steps.sample = window_sample(seed, p)
        _sync(device)
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        setup_s = time.perf_counter() - t_start - read_s
        with feeding(window, steps):
            window.t0 = t0 = time.perf_counter()
            res = workload.train_ctr_ps(
                cfg, steps=1 << 60, mode="async", num_shards=p["shards"],
                repin_interval=p["repin_interval"], depth=p["depth"],
                table=table, tower=checked["towers"][-1], device=device)
            _sync(device)
            wall = time.perf_counter() - t0
        log(t_start, f"window: {res['steps']} steps")
        if window.error is not None:
            raise RuntimeError("the window's batch stream failed") \
                from window.error
        dtrace = clock.read() if clock is not None else None
        peak = (torch.cuda.max_memory_allocated(device)
                if device.type == "cuda" else 0)
        tel = telemetry_delta(before, telemetry(table))
        final = table.to_dense().numpy()
        differing, cached = hot_rows_differing(table, final)
        log(t_start, "table and hot cache read back")
    finally:
        table.close()
    n = res["steps"]
    losses = np.asarray(res["losses"])
    return {
        "checked": checked, "setup_s": setup_s, "wall_s": wall, "steps": n,
        "examples": n * cfg.batch, "drawn": window.drawn,
        "memory_peak_bytes": peak, "trace": dtrace,
        "switches": clock.switches if clock is not None else [],
        "ctr": {"step_times": res["step_times"], "step_ts": res["step_ts"],
                "repin_steps": [i for i in range(1, n)
                                if i % p["repin_interval"] == 0],
                "repins": res["repins"], "wall_s": wall, **tel},
        "window": {"pushes_missing": n - tel["pushes"],
                   "batches_untrained": window.drawn - n,
                   "hot_rows_differing": differing, "cached_rows": cached,
                   "nonfinite_losses": int((~np.isfinite(losses)).sum()),
                   "first_loss": float(losses[0]),
                   "last_loss": float(losses[-1])},
        "pushed": {"before": table1, "after": final,
                   "batches": window.batches[:n], "grads": steps.grads[:n],
                   "kept": steps.kept},
    }


def run_reference(cell, seed: int, device, touched: np.ndarray, *,
                  quant=None) -> dict:
    """The plain reference over the checked steps from the seed's
    weights: losses, the tower's towers, and the touched rows' change."""
    c = cell.config["ctr"]
    stream = traffic.ClickStream(cell.traffic, c["cardinalities"], seed)
    batches = [stream.batch(i) for i in range(cell.params["checked_steps"])]
    table = ctr_reference.init_table(c, seed, device)
    idx = torch.as_tensor(touched, device=device)
    rows0 = table[idx].clone()
    r = ctr_reference.steps(c, table, ctr_reference.init_tower(c, seed,
                                                                device),
                            batches, quant=quant)
    change = (table[idx].double() - rows0.double()).cpu().numpy()
    del table
    return {"losses": r["losses"], "towers": r["towers"],
            "row_change": change}


def compare(prog: dict, ref: dict, cell) -> dict:
    """The judge's numbers for the checked steps: the worst step's
    relative loss gap; by the worst tower leaf, the gaps of the first
    gradient's norm and of the change's norm (leaves whose reference
    gradient is under a thousandth of the median leaf's move by
    round-off alone and are left out of the change); by the worst touched
    row, the gap of its change's norm, against the larger of its own and
    the median row's; and the rows outside the batches that changed."""
    c = cell.config["ctr"]
    pc = prog["checked"]
    loss_gap = max(abs(a - b) / abs(b)
                   for a, b in zip(pc["losses"], ref["losses"]))
    pg, pu = tower_norms(pc["towers"], c)
    rg, ru = tower_norms(ref["towers"], c)
    g, g_leaf = gap_by_worst_leaf(pg, rg)
    med = sorted(rg.values())[len(rg) // 2]
    moving = {k for k, v in rg.items() if v >= 1e-3 * med}
    u, u_leaf = gap_by_worst_leaf(pu, ru, moving)
    pn = np.linalg.norm(pc["row_change"], axis=1)
    rn = np.linalg.norm(ref["row_change"], axis=1)
    floor = np.maximum(rn, np.median(rn))
    gaps = np.abs(pn - rn) / np.maximum(floor, 1e-30)
    return {"loss_gap": loss_gap, "grad_norm_gap": g, "update_norm_gap": u,
            "row_norm_gap": float(gaps.max()),
            "stray_rows": pc["stray_rows"], "grad_leaf": g_leaf,
            "update_leaf": u_leaf, "worst_row": int(pc["touched"][
                gaps.argmax()]),
            "left_out": sorted(set(rg) - moving)}


def row_gap(p: torch.Tensor, r: torch.Tensor, d: int) -> float:
    """The worst row's gap of norms, against the larger of its own norm
    in ``r`` and the median row's."""
    pn = p.reshape(-1, d).double().norm(dim=1)
    rn = r.reshape(-1, d).double().norm(dim=1)
    floor = torch.clamp(rn, min=float(rn.median())).clamp_min(1e-30)
    return float(((pn - rn).abs() / floor).max())


def step_gaps(c: dict, tower: dict, got: tuple, ref: tuple) -> dict:
    """One window step against the reference's on the same inputs: the
    loss's relative gap, the tower's change by the worst leaf (leaves the
    reference moves by under a thousandth of the median leaf's left
    out) and the row gradients by the worst row.  ``got`` is ``(tower',
    row grads, loss)`` as the program's step returns it, ``ref`` ``(loss,
    tower', row grads)`` as the reference's."""
    ptower, pg, ploss = got
    rloss, rtower, rg = ref
    names = ctr_reference.leaf_names(c)
    t0 = ctr_reference.leaves(tower)

    def change(t):
        return {n: float((a.double() - b.double()).norm())
                for n, a, b in zip(names, ctr_reference.leaves(t), t0)}

    pu, ru = change(ptower), change(rtower)
    med = sorted(ru.values())[len(ru) // 2]
    u, _ = gap_by_worst_leaf(pu, ru, {k for k, v in ru.items()
                                      if v >= 1e-3 * med})
    return {"loss": abs(float(ploss) - rloss) / abs(rloss), "update": u,
            "grad": row_gap(pg, rg, c["emb_dim"])}


def judge_window(cell, pushed: dict, device, *, control: bool = False):
    """The window's own numbers: ``push_sum_gap``, the worst row's
    ‖after − before − Σ pushed‖ against the larger of its own ‖Σ
    pushed‖ and the median row's; ``window_stray_rows``, rows outside the
    window's batches that changed; and the worst of the sampled steps'
    ``window_loss_gap``, ``window_update_gap`` and ``window_grad_gap``.
    With ``control``, also the sampled steps' numbers of the control (the
    reference with the tower's products in bfloat16) in the program's
    place."""
    c = cell.config["ctr"]
    uniq, total = ctr_reference.push_sum(
        c, [b["ids"] for b in pushed["batches"]], pushed["grads"], device)
    u = uniq.cpu().numpy()
    before, after = pushed["before"], pushed["after"]
    got = {"window_stray_rows": stray_rows(before, after, u),
           "push_sum_gap": 0.0}
    if u.size:
        move = (torch.from_numpy(after[u]).to(device, torch.float64)
                - torch.from_numpy(before[u]).to(device, torch.float64))
        size = total.norm(dim=1)
        floor = torch.clamp(size, min=float(size.median())).clamp_min(1e-30)
        got["push_sum_gap"] = float(((move - total).norm(dim=1)
                                     / floor).max())
    del total
    gaps, ctl = [], []
    for j, (tower, emb, labels, out) in sorted(pushed["kept"].items()):
        ref = ctr_reference.step(c, tower, emb, labels)
        gaps.append(step_gaps(c, tower, out, ref))
        if control:
            q = ctr_reference.step(c, tower, emb, labels, quant="bf16")
            ctl.append(step_gaps(c, tower, (q[1], q[2], q[0]), ref))

    def worst(rows):
        return {f"window_{k}_gap": max((r[k] for r in rows), default=0.0)
                for k in ("loss", "update", "grad")}

    got.update(worst(gaps), sampled=sorted(pushed["kept"]))
    return got, (worst(ctl) if control else None)


def judged(cell, prog: dict, ref: dict) -> dict:
    return {**compare(prog, ref, cell), **prog["window"]}


def run(cell, *, seed: int, seconds: float, trace: bool, device,
        t_start: float) -> dict:
    prog = run_program(cell, seed, seconds, trace, device, t_start)
    free(device)
    t_check = time.perf_counter()
    prog["window"].update(judge_window(cell, prog.pop("pushed"), device)[0])
    free(device)
    ref = run_reference(cell, seed, device, prog["checked"]["touched"])
    free(device)
    got = judged(cell, prog, ref)
    checks, correct = verdict_checks(cell, got)
    B = cell.traffic["batch"]
    w = prog["window"]
    return {
        "attempted": prog["steps"], "failed": 0,
        "setup_s": prog["setup_s"], "wall_s": prog["wall_s"],
        "memory_peak_bytes": prog["memory_peak_bytes"],
        "e2e": {"ctr_examples_s": prog["examples"] / prog["wall_s"]},
        "ctr": prog["ctr"], "trace": prog["trace"],
        "switches": prog["switches"], "spans": [], "t0": None,
        "checks": checks, "correct": correct,
        "note": (f"setup {prog['setup_s']:.1f} s; {prog['steps']} steps of "
                 f"{B} in {prog['wall_s']:.3f} s ({prog['drawn']} batches "
                 f"drawn, {prog['ctr']['repins']} re-pins, "
                 f"{w['cached_rows']} rows cached; window steps "
                 f"{w['sampled']} sampled); checked losses "
                 f"{prog['checked']['losses']} vs reference "
                 f"{ref['losses']}; window loss {w['first_loss']:.4f} -> "
                 f"{w['last_loss']:.4f}; worst: leaf {got['grad_leaf']} / "
                 f"{got['update_leaf']}, row {got['worst_row']}; left out "
                 f"of the change: {got['left_out']}; reference check in "
                 f"{time.perf_counter() - t_check:.1f} s"),
    }


@contextlib.contextmanager
def plant(fault: str | None):
    """A fault planted in the program, for the calibration and the tests:
    ``half_batch`` (each step's loss over the first half of its batch,
    the other half's rows pushed no gradient) and ``half_batch_window``
    (the same in the window's steps alone), ``dropped_push`` (push number
    ``DROP_AT`` left out), ``skipped_write_through`` (pushes no longer
    reach the hot cache); in the asynchronous client alone, at its push
    number ``SPOIL_AT``, ``zeroed_push`` (the gradient pushed as zeros)
    and ``misrouted_push`` (the gradient pushed at the ids of the batch
    rolled by one example), and ``skipped_stream_wait`` (no side stream
    waits for the work it reads: the pulled rows, the gradients)."""
    from repro_torch.ps import client, sharding, workload

    saved = []

    def patch(obj, name, new):
        saved.append((obj, name, getattr(obj, name)))
        setattr(obj, name, new)

    if fault in ("half_batch", "half_batch_window"):
        make, made = workload.make_step_fn, [0]

        def half(cfg):
            inner = make(cfg)
            made[0] += 1
            if fault == "half_batch_window" and made[0] == 1:
                return inner

            def step(tower, emb, labels):
                h = emb.shape[0] // 2
                tower, g, loss = inner(tower, emb[:h], labels[:h])
                full = torch.zeros_like(emb)
                full[:h] = g
                return tower, full, loss
            return step
        patch(workload, "make_step_fn", half)
    elif fault == "dropped_push":
        push, calls = sharding.ShardedTable.push, [0]

        def dropping(self, *a, **kw):
            calls[0] += 1
            return self if calls[0] == DROP_AT else push(self, *a, **kw)
        patch(sharding.ShardedTable, "push", dropping)
    elif fault == "skipped_write_through":
        patch(sharding, "_hot_apply", lambda hot, slot, ids, upd: hot)
    elif fault in ("zeroed_push", "misrouted_push"):
        push, calls = client.PSClient.push, [0]

        def spoiling(self, ids, row_grads, **kw):
            calls[0] += 1
            if calls[0] == SPOIL_AT and fault == "zeroed_push":
                row_grads = torch.zeros_like(row_grads)
            elif calls[0] == SPOIL_AT:
                ids = np.roll(ids, 1, axis=0)
            return push(self, ids, row_grads, **kw)
        patch(client.PSClient, "push", spoiling)
    elif fault == "skipped_stream_wait":
        patch(client, "_receive", lambda t, ev, stream: None)
    elif fault is not None:
        raise ValueError(f"unknown fault {fault!r}")
    try:
        yield
    finally:
        for obj, name, old in reversed(saved):
            setattr(obj, name, old)


def calibrate(cell, seeds, seconds: float, device, fault, emit) -> None:
    """Per seed, the judge's numbers of a whole run (the window
    ``seconds`` long, and then to the end of its period) against the
    reference, with ``fault`` planted; with no fault, also the control's
    (the reference with the tower's products in bfloat16, in the
    program's place in the checked steps and in the sampled window
    steps), judged by the same limits."""
    for seed in seeds:
        t0 = time.perf_counter()
        rec = {"seed": seed, "fault": fault}
        with plant(fault):
            prog = run_program(cell, seed, seconds, False, device, t0)
        free(device)
        rec["program_s"] = time.perf_counter() - t0
        win, ctl_win = judge_window(cell, prog.pop("pushed"), device,
                                    control=fault is None)
        prog["window"].update(win)
        free(device)
        touched = prog["checked"]["touched"]
        ref = run_reference(cell, seed, device, touched)
        free(device)
        got = judged(cell, prog, ref)
        rec.update(got, correct=verdict_checks(cell, got)[1],
                   steps=prog["steps"], wall_s=prog["wall_s"],
                   ctr_examples_s=prog["examples"] / prog["wall_s"],
                   setup_s=prog["setup_s"],
                   check_s=time.perf_counter() - t0 - rec["program_s"])
        if fault is None:
            ctl = run_reference(cell, seed, device, touched, quant="bf16")
            free(device)
            cprog = {"checked": {**prog["checked"], **ctl, "stray_rows": 0},
                     "window": {**prog["window"], **ctl_win}}
            rec["control"] = {**compare(cprog, ref, cell), **ctl_win}
            rec["control_correct"] = verdict_checks(
                cell, judged(cell, cprog, ref))[1]
        emit(rec)
