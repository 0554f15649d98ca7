"""The CTR cells on the CPU at a test size: the ``ctr_ids`` traffic, the
plain reference against the program's loop, the driver's window, and the
judge with faults planted under the timed path (the chip's look for a
card is skipped: the driver is called directly)."""

import json
import time
import types

import numpy as np
import pytest
import torch

import _tiny
from harness import ctr_reference, spec, traffic

CPU = torch.device("cpu")
CARDS = _tiny.TINY_CTR["cardinalities"]


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cell(tmp_path):
    root = _tiny.write_bench(tmp_path)
    return spec.load_cell("ctr", root=root, bench_dir=root / "perfbench")


def _stream(seed, mix=None, cards=CARDS):
    return traffic.ClickStream(mix or _tiny.TINY_CTR_MIX, cards, seed)


def test_the_same_seed_and_step_give_the_same_batch():
    seed = 2**31 + 5
    a, b = _stream(seed), _stream(seed)
    later = a.batch(7)
    for k in (0, 7):     # made on demand: the order asked does not matter
        x, y = (s.batch(k) for s in (a, b))
        assert np.array_equal(x["ids"], y["ids"])
        assert np.array_equal(x["label"], y["label"])
    assert np.array_equal(later["ids"], b.batch(7)["ids"])
    assert not np.array_equal(a.batch(0)["ids"], a.batch(1)["ids"])
    assert not np.array_equal(a.batch(0)["ids"], _stream(6).batch(0)["ids"])


def test_each_slot_draws_its_own_rows_by_the_zipf_law():
    s = _stream(3)
    ids = np.concatenate([s.batch(k)["ids"] for k in range(200)])
    assert ids.dtype == np.int32
    lo = np.concatenate([[0], np.cumsum(CARDS)[:-1]])
    for j, (a, n) in enumerate(zip(lo, CARDS)):
        col = ids[:, j] - a
        assert col.min() >= 0 and col.max() < n
    # the three-row slot against p(r) ∝ r^-1.1 over 12,800 draws
    p = np.arange(1, 4, dtype=float) ** -1.1
    p /= p.sum()
    got = np.bincount(ids[:, 3] - lo[3], minlength=3) / len(ids)
    assert np.allclose(got, p, atol=0.015)
    assert np.allclose(traffic.zipf_cdf(3, 1.1), np.cumsum(p), rtol=1e-12)


@pytest.mark.parametrize("batch", [64, 2048])
def test_every_step_holds_a_quarter_of_clicks(batch):
    mix = {**_tiny.TINY_CTR_MIX, "batch": batch}
    s = _stream(2**33 + 1, mix)
    for k in range(5):
        rate = s.batch(k)["label"].mean()
        assert 0.25 <= rate <= 0.26
    # the clicks follow the ids: the score ranks clicks above the rest
    b = s.batch(0)
    score = (np.cos(b["ids"] * traffic.GOLDEN_ANGLE) * s.weights).sum(1)
    assert score[b["label"] == 1].mean() > score[b["label"] == 0].mean()


def _program_sync(c, table0, tower0, batches, steps=3):
    """The program's loop over ``batches``, synchronous, in-process shards."""
    from repro_torch.ps import workload

    drv = spec.load_driver(types.SimpleNamespace(
        driver="ctr", bench_dir=spec.BENCH_DIR))
    cfg = workload.CTRConfig(vocab=c["vocab"], emb_dim=c["emb_dim"],
                             slots=c["slots"], tower=tuple(c["tower"]),
                             batch=len(batches[0]["label"]), lr=c["lr"],
                             emb_lr_scale=c["emb_lr_scale"])
    table = workload.make_table(cfg, 2, transport="inproc", device=CPU,
                                dense=table0.clone())
    seen = drv.Steps()
    try:
        with drv.feeding(batches, seen):
            res = workload.train_ctr_ps(cfg, steps=steps, mode="sync",
                                        repin_interval=1, table=table,
                                        tower=tower0, device=CPU)
        return res, [tower0, *seen.towers], table.to_dense()
    finally:
        table.close()


def test_the_reference_follows_the_program_over_three_sync_steps():
    c = _tiny.TINY_CTR
    table0 = ctr_reference.init_table(c, 9, CPU)
    tower0 = ctr_reference.init_tower(c, 9, CPU)
    batches = [_stream(9).batch(k) for k in range(3)]
    res, towers, table3 = _program_sync(c, table0, tower0, batches)
    assert res["hot_pulls"] >= 1     # the last pulls went through the cache
    ref_table = table0.clone()
    ref = ctr_reference.steps(c, ref_table, tower0, batches)
    assert np.allclose(res["losses"], ref["losses"], rtol=1e-6, atol=0)
    for a, b in zip(ctr_reference.leaves(towers[-1]),
                    ctr_reference.leaves(ref["towers"][-1])):
        assert torch.allclose(a, b, rtol=1e-5, atol=1e-7)
    assert torch.allclose(table3, ref_table, rtol=0, atol=1e-7)
    assert not torch.equal(table3, table0)
    # the control, in bfloat16, moves the rows by far more
    ctl_table = table0.clone()
    ctr_reference.steps(c, ctl_table, tower0, batches, quant="bf16")
    assert not torch.allclose(ctl_table, ref_table, rtol=0, atol=1e-6)


@pytest.mark.parametrize("repin_interval", [1, 5])
def test_fed_its_own_stream_the_program_gives_its_own_losses(repin_interval):
    """The driver's substitution is neutral: fed ``click_stream(cfg)``, the
    synchronous loop reproduces its default losses bit for bit; the
    asynchronous one (whose later losses follow the threads' timing) its
    first loss and its number of steps."""
    from repro_torch.ps import workload

    drv = spec.load_driver(types.SimpleNamespace(
        driver="ctr", bench_dir=spec.BENCH_DIR))
    cfg = workload.CTRConfig(vocab=5000, batch=32, tower=(32, 16))
    for mode in ("sync", "async"):
        kw = dict(steps=12, mode=mode, repin_interval=repin_interval,
                  transport="inproc", device="cpu")
        base = workload.train_ctr_ps(cfg, **kw)
        seen = drv.Steps()
        with drv.feeding(workload.click_stream(cfg), seen):
            fed = workload.train_ctr_ps(cfg, **kw)
        if mode == "sync":
            assert fed["losses"] == base["losses"]
        assert fed["losses"][0] == base["losses"][0]
        assert fed["steps"] == 12 and fed["repins"] == base["repins"]
        assert seen.count == 12 and len(seen.towers) == 12
    # and the program's own functions are back once the call is done
    assert workload.click_stream.__name__ == "click_stream"
    assert workload.make_step_fn.__name__ == "make_step_fn"


def test_the_window_ends_on_a_period_with_every_push_applied(cell):
    drv = spec.load_driver(cell)
    out = drv.run(cell, seed=2**31 + 3, seconds=0.3, trace=False,
                  device=CPU, t_start=time.perf_counter())
    assert out["correct"], out["checks"]
    n = out["attempted"]
    assert n >= 10 and n % cell.params["repin_interval"] == 0
    ctr = out["ctr"]
    assert ctr["pushes"] == n == len(ctr["step_times"])
    assert ctr["repin_steps"] == list(range(10, n, 10))
    assert ctr["repins"] == len(ctr["repin_steps"])
    assert out["checks"]["hot_rows_differing"]["value"] == 0
    assert out["e2e"]["ctr_examples_s"] > 0


@pytest.mark.parametrize("fault, number", [
    ("dropped_push", "pushes_missing"),
    ("skipped_write_through", "hot_rows_differing"),
    ("half_batch", "loss_gap"),
    ("zeroed_push", "push_sum_gap"),
    ("misrouted_push", "push_sum_gap"),
    ("half_batch_window", "window_grad_gap"),
])
def test_a_fault_under_the_timed_path_is_not_correct(cell, fault, number):
    drv = spec.load_driver(cell)
    with drv.plant(fault):
        out = drv.run(cell, seed=2**31 + 4, seconds=0.2, trace=False,
                      device=CPU, t_start=time.perf_counter())
    c = out["checks"][number]
    assert c["value"] > c["limit"] and not out["correct"]


def test_the_control_and_an_unchanged_state_fail_the_limits(cell):
    drv = spec.load_driver(cell)
    t0 = time.perf_counter()
    prog = drv.run_program(cell, 21, 0.1, False, CPU, t0)
    prog["window"].update(drv.judge_window(cell, prog.pop("pushed"), CPU)[0])
    touched = prog["checked"]["touched"]
    ref = drv.run_reference(cell, 21, CPU, touched)
    assert drv.verdict_checks(cell, drv.judged(cell, prog, ref))[1]
    ctl = drv.run_reference(cell, 21, CPU, touched, quant="bf16")
    as_prog = {"checked": {**prog["checked"], **ctl, "stray_rows": 0},
               "window": prog["window"]}
    assert not drv.verdict_checks(cell, drv.judged(cell, as_prog, ref))[1]
    # a state left unchanged reads 1 on the rows and on the tower
    still = {"checked": {**prog["checked"],
                         "row_change": 0 * prog["checked"]["row_change"],
                         "towers": [prog["checked"]["towers"][0]] * 4},
             "window": prog["window"]}
    got = drv.compare(still, ref, cell)
    assert got["row_norm_gap"] == pytest.approx(1.0)
    assert got["update_norm_gap"] == pytest.approx(1.0)


def test_the_window_is_judged_by_its_pushes_and_sampled_steps(cell):
    """The window's pushes add up to the table's change, its sampled steps
    equal the reference's on their own inputs, and the control in their
    place fails the window's limits."""
    drv = spec.load_driver(cell)
    seed = 2**31 + 8
    prog = drv.run_program(cell, seed, 0.1, False, CPU, time.perf_counter())
    pushed = prog["pushed"]
    n = prog["steps"]
    assert len(pushed["grads"]) == len(pushed["batches"]) == n
    assert sorted(pushed["kept"]) == sorted(drv.window_sample(seed,
                                                              cell.params))
    assert len(pushed["kept"]) == drv.SAMPLED
    got, ctl = drv.judge_window(cell, pushed, CPU, control=True)
    lim = cell.params["limits"]
    assert got["window_stray_rows"] == 0
    for k in ("push_sum_gap", "window_loss_gap", "window_update_gap",
              "window_grad_gap"):
        assert got[k] <= lim[k], (k, got[k])
    assert any(ctl[k] > lim[k] for k in ctl)
    # the rows the window moved: the table's change is the pushes' sum
    assert not np.array_equal(pushed["before"], pushed["after"])


def test_the_ctr_cell_prints_its_metrics_and_checks(cell):
    import run

    drv = spec.load_driver(cell)
    out = drv.run(cell, seed=17, seconds=0.2, trace=False, device=CPU,
                  t_start=time.perf_counter())
    dev = {"platform": "cpu", "kind": "cpu", "count": 1,
           "memory_peak_bytes": 0}
    e2e = run.result_line(cell, out, False, dev)
    assert set(e2e["metrics"]) == {"ctr_examples_s", "setup_s"}
    layer = run.result_line(cell, out, True, dev)
    # no device trace on the CPU: the idle share has nothing to read
    assert set(layer["metrics"]) == set(_tiny.CTR_METRICS) - {
        "device_idle.ctr"}
    assert list(layer)[-1] == "checks"
    assert set(layer["checks"]) == set(_tiny.CTR_LIMITS)
    json.dumps(layer)
