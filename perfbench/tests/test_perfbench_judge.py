"""The judge turns ``correct`` false when the timed path is broken
underneath, and for the control (the plain reference in float8 in the
program's place), driving the rest of a run on the CPU at a test size
(the chip's look for a card is skipped: the drivers are called directly).
"""

import time

import pytest
import torch

import _tiny
from harness import spec

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _cell(tmp_path, name, **kw):
    root = _tiny.write_bench(tmp_path, **kw)
    return spec.load_cell(name, root=root, bench_dir=root / "perfbench")


def _run(cell, seed=2**31 + 11, seconds=1.5):
    drv = spec.load_driver(cell)
    return drv.run(cell, seed=seed, seconds=seconds, trace=False, device=CPU,
                   t_start=time.perf_counter())


@pytest.mark.parametrize("kind", ["moe", "dense"])
def test_serving_is_correct_and_its_control_is_not(tmp_path, kind):
    cell = _cell(tmp_path, f"serve-{kind}", kind=kind)
    out = _run(cell)
    assert out["correct"], out["checks"]
    assert out["attempted"] == 9 and out["failed"] == 0
    drv = spec.load_driver(cell)
    st = drv.prepare(cell, 3, CPU)
    reqs = drv.make_requests(st, 3, 1.5)
    res, _ = drv.window(st, reqs, 1.5)
    v = drv.check(st, reqs, res, 3, control=True)
    assert v["max_logit_gap"] <= _tiny.SERVE_LIMIT
    assert v["control_max_logit_gap"] > _tiny.SERVE_LIMIT


def test_serving_with_a_token_altered_where_produced_is_not_correct(
        tmp_path, monkeypatch):
    from repro_torch.models import decoder as dec

    orig = dec.decode_loop

    def altered(params, cfg, token, cache, index, steps, **kw):
        toks, ntok, cache = orig(params, cfg, token, cache, index, steps,
                                 **kw)
        toks = toks.clone()
        toks[:, 1] = (toks[:, 1] + 1) % cfg.vocab
        return toks, ntok, cache

    monkeypatch.setattr(dec, "decode_loop", altered)
    out = _run(_cell(tmp_path, "serve-moe"))
    assert not out["correct"]
    assert out["checks"]["max_logit_gap"]["value"] > _tiny.SERVE_LIMIT


def test_offline_cell_counts_partial_answers_and_is_judged(tmp_path):
    out = _run(_cell(tmp_path, "offline-moe"), seconds=3.0)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] >= 4
    assert out["e2e"]["out_tok_s"] > 0


def test_training_is_correct_and_its_control_is_not(tmp_path):
    cell = _cell(tmp_path, "train")
    out = _run(cell, seconds=0.5)
    assert out["correct"], out["checks"]
    drv = spec.load_driver(cell)
    ref = drv.run_reference(cell, 4, CPU)
    ctl = drv.compare(drv.run_reference(cell, 4, CPU, quant="fp8"), ref, cell)
    assert any(ctl[k] > v for k, v in _tiny.TRAIN_LIMITS.items()), ctl


def test_training_step_that_leaves_the_state_unchanged_is_not_correct(
        tmp_path, monkeypatch):
    from repro_torch.launch import steps

    monkeypatch.setattr(steps, "adamw_update",
                        lambda params, grads, state, **kw: (params, state))
    out = _run(_cell(tmp_path, "train"), seconds=0.3)
    assert not out["correct"]
    assert out["checks"]["update_norm_gap"]["value"] == pytest.approx(1.0)


def test_training_on_half_the_batch_is_not_correct(tmp_path, monkeypatch):
    from repro_torch.models import decoder as dec

    orig = dec.loss_fn

    def half(params, cfg, batch, **kw):
        n = batch["tokens"].shape[0] // 2
        return orig(params, cfg, {k: v[:n] for k, v in batch.items()}, **kw)

    monkeypatch.setattr(dec, "loss_fn", half)
    out = _run(_cell(tmp_path, "train"), seconds=0.3)
    assert not out["correct"]
    assert out["checks"]["loss_gap"]["value"] > _tiny.TRAIN_LIMITS["loss_gap"]
