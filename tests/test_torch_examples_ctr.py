"""The port's ``repro_torch.examples.heterps_ctr_pipeline`` against the
reference's ``examples/heterps_ctr_pipeline.py`` on the CPU.

Both run at a reduced size, set through the modules' constants: a
``VOCAB``-row table (the reference's ``STREAM_CFG`` rebuilt at it), 60
steps, a re-pin every 20 and ``ROUNDS`` RL rounds.  The port starts from
the reference's weights: the reference's ``jax.jit`` is wrapped
(``JitRecorder``) to keep the first step's arguments — its initial
``in_proj``, stages and ``head_w`` — and its result, and its table is
drawn again from the same key; ``weights_from_numpy`` carries them
across.

What is compared, and how:
- re-pins, and every shard's pulled and pushed rows and bytes: exactly
  (they follow the click stream and the dedup alone);
- the tier counts only sum to the vocabulary with some hot rows in each
  package: the re-pin ages the access counts while the puller thread
  keeps recording up to two batches ahead, so which rows are hot depends
  on timing;
- the step-0 loss within 1e-5 (no push has landed yet).  Later losses
  are not compared: the async client pulls rows before the previous
  steps' pushes land, by a number of steps that depends on timing;
- one pipelined tower step (loss and the gradients of the rows,
  ``in_proj``, the stages and ``head_w``) for a fixed batch and fixed
  rows, against the reference's own jitted step on the same weights,
  within 1e-5;
- ``--chaos``: the drift is exactly 0, with the reference's crashes,
  restores and checkpoints.
"""

from __future__ import annotations

import contextlib
import io
import re
import sys

import jax
import numpy as np
import pytest
import torch

from _torch_examples import (JitRecorder, load_chip_smoke, load_reference,
                             one_thread, patch_r1, record_instances)
from repro.ps.sharding import RoutingSpec as JSpec
from repro.ps.sharding import ShardedTable as JTable
from repro.ps.workload import CTRConfig as JConfig
from repro.ps.workload import click_stream as jclick_stream
from repro_torch.examples import heterps_ctr_pipeline as tctr
from repro_torch.launch.mesh import close_process_group
from repro_torch.parallel.pipeline import make_stage_mesh

VOCAB = 5_000
STEPS = 60
REPIN_EVERY = 20
ROUNDS = 8
LR = 0.05


@pytest.fixture(scope="module", autouse=True)
def _threads():
    yield from one_thread()


def _run(fn):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn()
    return out, buf.getvalue().splitlines()


def _stage_list(stacked, n_stages):
    """The reference's stacked ``{"layers": [{"w", "b"}, ...]}`` as its
    per-stage ``stage_list`` in NumPy."""
    return [{"layers": [{k: np.asarray(v[s]) for k, v in layer.items()}
                        for layer in stacked["layers"]]}
            for s in range(n_stages)]


@pytest.fixture(scope="module")
def reference():
    ref = load_reference("heterps_ctr_pipeline")
    jit = JitRecorder()
    with pytest.MonkeyPatch.context() as mp:
        patch_r1(mp)
        mp.setattr(ref, "VOCAB", VOCAB)
        mp.setattr(ref, "REPIN_EVERY", REPIN_EVERY)
        mp.setattr(ref, "STREAM_CFG", ref.CTRConfig(
            vocab=VOCAB, emb_dim=ref.EMB_DIM, slots=ref.SLOTS,
            batch=ref.MICRO * ref.MB, seed=0))
        mp.setattr(ref, "jax", jit)
        record_instances(mp, ref, "RLScheduler", rounds=ROUNDS)
        tables = record_instances(mp, ref, "ShardedTable")
        placers = record_instances(mp, ref, "TierPlacer")
        mp.setattr(sys, "argv", ["heterps_ctr_pipeline.py", "--steps",
                                 str(STEPS), "--lr", str(LR)])
        _, lines = _run(ref.main)
    (emb, in_proj, stages, head_w, labels), (loss, _) = jit.calls[0]
    weights = {"in_proj": np.asarray(in_proj),
               "stage_list": _stage_list(stages, ref.N_STAGES),
               "head_w": np.asarray(head_w)}
    dense = np.asarray(JTable(VOCAB, ref.EMB_DIM, ref.PS_SHARDS,
                              jax.random.PRNGKey(0),
                              init_scale=0.05).to_dense())
    table, placer = tables[0], placers[0]
    return {"lines": lines, "weights": weights, "dense": dense,
            "step_fn": jit.fns[0], "first_loss": float(loss),
            "shards": table.telemetry.shard_report(),
            "tiers": table.monitor.stats(), "repins": placer.repins,
            "stages": stages}


@pytest.fixture(scope="module")
def port(reference):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tctr, "VOCAB", VOCAB)
        mp.setattr(tctr, "REPIN_EVERY", REPIN_EVERY)
        mp.setattr(tctr, "RL_ROUNDS", ROUNDS)
        out, lines = _run(lambda: tctr.train_pipeline(
            steps=STEPS, lr=LR, device="cpu", weights=reference["weights"],
            dense=reference["dense"]))
    return {"out": out, "lines": lines}


def test_repins_equal_the_reference(reference, port):
    # at steps 20 and 40: the placer skips step 0
    assert (port["out"]["repins"] == reference["repins"]
            == (STEPS - 1) // REPIN_EVERY)


@pytest.mark.parametrize("shard", range(tctr.PS_SHARDS))
def test_shard_traffic_equals_the_reference(reference, port, shard):
    ref = reference["shards"][shard]
    got = port["out"]["shards"][shard]
    for key in ("shard", "pull_rows", "pull_bytes", "push_rows",
                "push_bytes"):
        assert got[key] == ref[key], key


def test_tiers_cover_the_vocabulary(reference, port):
    for tiers in (port["out"]["tiers"], reference["tiers"]):
        assert tiers["device_rows"] + tiers["host_rows"] + tiers[
            "disk_rows"] == VOCAB
        assert 0 < tiers["device_rows"] <= 4096
    assert port["out"]["hot_pulls"] > 0


def test_first_loss_equals_the_reference(reference, port):
    assert port["out"]["steps"] == STEPS
    assert abs(port["out"]["first_loss"] - reference["first_loss"]) <= 1e-5


def test_model_is_the_reference_model(reference, port):
    out = port["out"]
    assert out["pipeline_devices"] == 1
    assert out["params"] == VOCAB * tctr.EMB_DIM + sum(
        a.size for a in (reference["weights"]["in_proj"],
                         reference["weights"]["head_w"])) + sum(
        np.asarray(v).size for layer in reference["stages"]["layers"]
        for v in layer.values())


def _skeleton(line: str) -> str:
    """``line`` with its numbers masked and its runs of spaces made one
    (a measured column's width follows its digits)."""
    return " ".join(re.sub(r"[0-9]+(\.[0-9]+)?", "#", line).split())


def test_prints_the_reference_lines(reference, port):
    assert ([_skeleton(s) for s in port["lines"]]
            == [_skeleton(s) for s in reference["lines"]])


def test_tower_step_equals_the_reference(reference):
    """One pipelined step of the tower on the reference's weights, for a
    fixed batch of rows and labels: the reference's jitted
    ``value_and_grad`` against :func:`tower_loss` and autograd."""
    rng = np.random.default_rng(7)
    B = tctr.MICRO * tctr.MB
    emb = (rng.standard_normal((B, tctr.SLOTS, tctr.EMB_DIM)) * 0.05).astype(
        np.float32)
    labels = (rng.random(B) > 0.5).astype(np.float32)
    w = reference["weights"]
    jloss, jgrads = jax.jit(reference["step_fn"])(
        emb, w["in_proj"], reference["stages"], w["head_w"], labels)
    want = [np.asarray(jgrads[0]), np.asarray(jgrads[1]),
            *[np.asarray(g) for layer in jgrads[2]["layers"]
              for g in layer.values()],
            np.asarray(jgrads[3])]

    model = tctr.tower_from_numpy(w, device="cpu")
    mesh = make_stage_mesh(1, device_type="cpu", backend="gloo")
    try:
        rows = torch.from_numpy(emb).requires_grad_()
        loss = tctr.tower_loss(rows, model["in_proj"], model["stage_params"],
                               model["head_w"], torch.from_numpy(labels),
                               mesh)
        got = torch.autograd.grad(loss, [rows, *tctr.dense_params(model)])
    finally:
        close_process_group()
    assert abs(loss.item() - float(jloss)) <= 1e-5
    assert len(got) == len(want)
    for g, r in zip(got, want):
        np.testing.assert_allclose(g.numpy(), r, atol=1e-5, rtol=1e-5)


def _chaos_line(lines):
    text = "\n".join(lines)
    m = re.search(r"crashes injected: (\d+), restores: (\d+), "
                  r"checkpoints: (\[.*\])", text)
    return int(m.group(1)), int(m.group(2)), m.group(3)


def test_chaos_replays_bit_exactly_as_the_reference():
    ref = load_reference("heterps_ctr_pipeline")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sys, "argv", ["heterps_ctr_pipeline.py", "--chaos"])
        _, ref_lines = _run(ref.main)
    out, lines = _run(lambda: tctr.main(["--chaos", "--device", "cpu"]))
    assert out["drift"] == 0.0
    assert out["calm_losses"] == out["chaos_losses"]
    assert out["restores"] >= 1 and out["crashes"] >= 1
    assert (out["crashes"], out["restores"], str(out["checkpoints"])) \
        == _chaos_line(ref_lines)
    assert "max |loss drift| vs calm run: 0.00e+00 (bit-exact)" in ref_lines
    assert lines[-1] == ref_lines[-1]
    cs = load_chip_smoke()
    assert (cs.REF_CHAOS["crashes"], cs.REF_CHAOS["restores"],
            str(cs.REF_CHAOS["checkpoints"])) == _chaos_line(ref_lines)


def _stream_rows(vocab: int, steps: int) -> tuple[list[int], list[int]]:
    """Per-shard rows the reference's click stream sends at the example's
    batch geometry over ``steps`` steps: every id pulled, each step's
    distinct ids pushed (the push deduplicates), routed by the
    reference's ``RoutingSpec``."""
    spec = JSpec(vocab, 32, 4, "mod")
    stream = jclick_stream(JConfig(vocab=vocab, emb_dim=32, slots=26,
                                   batch=8 * 32, seed=0))
    pull, push = np.zeros(4, np.int64), np.zeros(4, np.int64)
    for _ in range(steps):
        ids = next(stream)["ids"].ravel()
        pull += np.bincount(np.asarray(spec.route(ids)[0]), minlength=4)
        push += np.bincount(np.asarray(spec.route(np.unique(ids))[0]),
                            minlength=4)
    return pull.tolist(), push.tolist()


def test_chip_smoke_ctr_rows_are_the_reference_stream_rows(reference):
    """``REF_CTR``, which phase 19 holds the card's run to: the
    reference's re-pins and per-shard rows at the example's defaults (a
    2,000,000-row table, 300 steps, a re-pin every 50), counted from the
    reference's click stream — the count that equals the reference's
    telemetry at this file's size."""
    ref = load_reference("heterps_ctr_pipeline")
    cs = load_chip_smoke()
    assert ([s["pull_rows"] for s in reference["shards"]],
            [s["push_rows"] for s in reference["shards"]]) \
        == _stream_rows(VOCAB, STEPS)
    assert (cs.REF_CTR["pull_rows"], cs.REF_CTR["push_rows"]) \
        == _stream_rows(ref.VOCAB, 300)
    assert cs.REF_CTR["repins"] == (300 - 1) // ref.REPIN_EVERY
