"""The port's chaos layer (``repro_torch.ps.faults``, ``.snapshot`` and
the elastic trainer's restore-and-replay) against the JAX reference on
the CPU.

The reference's contract (``tests/test_chaos.py``), run on the port:

* **schedule** — ``parse_schedule``/``FaultRule`` are a deterministic
  failure oracle, and the port's equals the reference's: the same spec
  parses to the same rules, and the same seed and traffic fire the same
  injections at the same requests;
* **masking** — every non-``crash`` fault is absorbed by the transport
  retry layer + server seq-dedup, and the loss trajectory stays
  bit-exact vs a fault-free run (and within 1e-4 of the reference's, from
  the reference's table and tower);
* **detection** — a hung worker escalates with context, a dead one
  reports its exit code, the heartbeat notices a dead shard with no
  traffic;
* **durability** — killing a bucket's primary *and* backup is survived
  only through the unified checkpoint: the run restores the newest
  complete step and replays to the fault-free trajectory, bit for bit.
  Each package loads the other's fleet checkpoints.
"""

from __future__ import annotations

import dataclasses
import os
import signal
import time

import jax
import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings, strategies as st
except ImportError:   # in-repo deterministic fallback
    from _hypothesis_fallback import given, settings, st

from repro.core.resources import CPU_CORE as J_CPU
from repro.obs import bridge as jbr
from repro.ps import elastic as jel
from repro.ps import faults as jfa
from repro.ps import snapshot as jsn
from repro.ps import transport as jtr
from repro.ps import workload as jw
from repro_torch.checkpoint import read_pointer
from repro_torch.core.resources import CPU_CORE as T_CPU
from repro_torch.obs import bridge as tbr
from repro_torch.ps import faults as tfa
from repro_torch.ps import transport as ttr
from repro_torch.ps import workload as tw
from repro_torch.ps.elastic import ElasticPSFleet, PSUnrecoverable
from repro_torch.ps.faults import FaultInjector, FaultRule, parse_schedule
from repro_torch.ps.snapshot import (
    FleetCheckpointer, list_checkpoints, load_fleet_checkpoint,
    save_fleet_checkpoint, snapshot_fleet,
)
from repro_torch.ps.transport import (
    InProcTransport, MultiprocTransport, PSShardLost, RetryPolicy,
)

VOCAB, DIM = 97, 4
HARD_TIMEOUT_S = 300

#: every fault kind the retry layer must absorb (tests/test_chaos.py)
MASK_SCHED = ("drop_reply,op=grad,after=10,times=2;"
              "dup_reply,op=pull,after=5,times=2;"
              "recv_error,after=20,times=2;"
              "delay,delay_s=0.001,prob=0.3")

#: correlated loss: both replicas of every bucket die inside one step.
#: ``after`` counts global transport attempts — fleet startup is ~24
#: creates, each sync step ~9 attempts (3 shards), each checkpoint drain
#: +12 — so 170 lands ~step 14, after the step-9 checkpoint.
KILL_BOTH = ("crash,op=grad,shard=0,after=170,times=1;"
             "crash,op=grad,shard=1,after=170,times=1")

CTR_SMALL = dict(vocab=5_000, emb_dim=8, slots=8, tower=(32,), batch=64)


@pytest.fixture(autouse=True)
def hard_timeout():
    """SIGALRM per-test ceiling: a wedged shard process fails the test
    instead of wedging the runner."""
    def boom(signum, frame):
        raise TimeoutError(
            f"test exceeded the {HARD_TIMEOUT_S}s hard timeout")

    old = signal.signal(signal.SIGALRM, boom)
    signal.alarm(HARD_TIMEOUT_S)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)


def _assert_ownership_partition(fleet):
    stats = fleet.stats()
    live = set(stats["live_shards"])
    hosted = {s: set(rep["buckets"]) for s, rep in stats["shards"].items()}
    for b in range(fleet.spec.num_buckets):
        p = stats["primary"][b]
        assert p in live, f"bucket {b} primary {p} is not live"
        assert b in hosted[p], f"shard {p} does not host its bucket {b}"
        k = stats["backup"][b]
        if k >= 0:
            assert k in live and k != p
            assert b in hosted[k]


def _small_fleet(**kw):
    return ElasticPSFleet(VOCAB, DIM, num_shards=3, num_buckets=6,
                          optimizer=kw.pop("optimizer", "adagrad"),
                          device="cpu", **kw)


# --------------------------------------------------------------------------
# the schedule and the injector
# --------------------------------------------------------------------------

SPECS = [
    "crash,op=grad,shard=1,after=50,times=1;"
    "delay,delay_s=0.01,prob=0.2,until=90",
    MASK_SCHED,
    KILL_BOTH,
    None,
    [{"kind": "crash", "shard": 0}, {"kind": "delay", "delay_s": 1.0}],
]


@pytest.mark.parametrize("spec", SPECS, ids=range(len(SPECS)))
def test_parse_schedule_equals_the_reference(spec):
    got = [dataclasses.asdict(r) for r in parse_schedule(spec)]
    want = [dataclasses.asdict(r) for r in jfa.parse_schedule(spec)]
    assert got == want


class TestSchedule:
    def test_parse_string_round_trip(self):
        rules = parse_schedule(
            "crash,op=grad,shard=1,after=50,times=1;"
            "delay,delay_s=0.01,prob=0.2,until=90")
        assert [r.kind for r in rules] == ["crash", "delay"]
        assert rules[0].op == "grad" and rules[0].shard == 1
        assert rules[0].after == 50 and rules[0].times == 1
        assert rules[1].delay_s == 0.01 and rules[1].prob == 0.2
        assert rules[1].until == 90

    def test_parse_accepts_rules_dicts_none(self):
        assert parse_schedule(None) == []
        rules = parse_schedule([FaultRule("delay", delay_s=1.0),
                                {"kind": "crash", "shard": 0}])
        assert rules[0].delay_s == 1.0 and rules[1].shard == 0

    def test_unknown_kind_rejected(self):
        with pytest.raises(ValueError):
            parse_schedule("meteor_strike")
        with pytest.raises(ValueError):
            FaultRule("meteor_strike")

    def test_bad_token_rejected(self):
        with pytest.raises(ValueError):
            parse_schedule("delay,oops")

    def test_rule_window_and_budget(self):
        r = FaultRule("delay", op="pull", after=3, until=6, times=2)
        assert not r.matches(2, "pull", 0)      # before the window
        assert r.matches(3, "pull", 0)
        assert not r.matches(3, "grad", 0)      # op filter
        assert not r.matches(6, "pull", 0)      # window closed
        r.fired = 2
        assert not r.matches(4, "pull", 0)      # budget exhausted


def _injector_traffic(schedule, seed, *, faults=tfa, transport=ttr):
    """A fixed op sequence through a wrapped in-proc shard of one
    package's injector and transport; returns the fired-injection log and
    the transport counters."""
    tr = faults.FaultInjector(transport.InProcTransport(), schedule,
                              seed=seed)
    tr.add_shard(0, dim=DIM)
    tr.request(0, {"op": "create", "bucket": 0,
                   "rows": np.zeros((8, DIM), np.float32)})
    try:
        for i in range(40):
            tr.request(0, {"op": "pull", "buckets": np.array([0]),
                           "ids": np.array([i % 8])})
        return list(tr.injections), dict(tr.counters)
    finally:
        tr.close()


@pytest.mark.parametrize("seed", [0, 7, 12])
@pytest.mark.parametrize("sched", [
    "delay,prob=0.5,delay_s=0.0;recv_error,after=10,times=2",
    "dup_reply,after=2,times=2;drop_reply,after=8,times=2;"
    "delay,prob=0.4,delay_s=0.0",
])
def test_injections_equal_the_reference(sched, seed):
    got, got_counters = _injector_traffic(sched, seed)
    want, want_counters = _injector_traffic(sched, seed, faults=jfa,
                                            transport=jtr)
    assert got == want and got
    assert got_counters == want_counters


class TestInjectorDeterminism:
    def test_same_seed_same_injections(self):
        sched = "delay,prob=0.5,delay_s=0.0;recv_error,after=10,times=2"
        a, _ = _injector_traffic(sched, seed=7)
        b, _ = _injector_traffic(sched, seed=7)
        assert a == b and len(a) > 0

    def test_seed_drives_probabilistic_rules(self):
        sched = "delay,prob=0.5,delay_s=0.0"
        a, _ = _injector_traffic(sched, seed=1)
        b, _ = _injector_traffic(sched, seed=2)
        assert a != b
        for fires in (a, b):
            assert 0 < len(fires) < 40


class TestRetryMasking:
    """Transport level: each non-crash kind is absorbed with the state
    bit-identical to a fault-free application."""

    def _one_shard(self, schedule, seed=0):
        tr = FaultInjector(InProcTransport(), schedule, seed=seed)
        tr.add_shard(0, dim=DIM, optimizer="sgd")
        tr.request(0, {"op": "create", "bucket": 0,
                       "rows": np.zeros((8, DIM), np.float32)})
        return tr

    def _grad(self):
        return {"op": "grad", "buckets": np.array([0, 0]),
                "ids": np.array([1, 4]),
                "grads": np.ones((2, DIM), np.float32), "lr": 0.1}

    def test_drop_reply_applies_exactly_once(self):
        tr = self._one_shard("drop_reply,op=grad,times=1")
        try:
            tr.request(0, self._grad())
            rows = tr.request(0, {"op": "snapshot", "bucket": 0})["rows"]
            assert np.allclose(rows[1], -0.1)   # one application of lr=0.1
            assert tr.counters["retries"] >= 1
            stats = tr.request(0, {"op": "stats"})
            assert stats["counters"]["dedup_replays"] >= 1
        finally:
            tr.close()

    def test_dup_reply_stale_seq_discarded(self):
        tr = self._one_shard("dup_reply,op=pull,times=1")
        try:
            out = tr.request(0, {"op": "pull", "buckets": np.array([0]),
                                 "ids": np.array([2])})
            assert np.array_equal(out["rows"], np.zeros((1, DIM)))
            assert tr.counters["stale_replies"] >= 1
        finally:
            tr.close()

    def test_recv_error_resend_is_first_delivery(self):
        tr = self._one_shard("recv_error,op=grad,times=1")
        try:
            tr.request(0, self._grad())
            rows = tr.request(0, {"op": "snapshot", "bucket": 0})["rows"]
            assert np.allclose(rows[1], -0.1)
            assert tr.counters["retries"] >= 1
            stats = tr.request(0, {"op": "stats"})
            assert stats["counters"]["dedup_replays"] == 0
        finally:
            tr.close()

    def test_crash_surfaces_as_lost_with_shard_ids(self):
        tr = self._one_shard("crash,op=grad,times=1")
        try:
            with pytest.raises(PSShardLost) as ei:
                tr.request(0, self._grad())
            assert ei.value.shard_ids == {0}
            assert 0 not in tr.live_shards
        finally:
            tr.close()

    def test_exhausted_retries_escalate(self):
        tr = FaultInjector(
            InProcTransport(retry=RetryPolicy(max_attempts=2,
                                              backoff_s=0.001)),
            "recv_error", seed=0)   # unbounded: every attempt fails
        tr.add_shard(0, dim=DIM)
        try:
            with pytest.raises(PSShardLost) as ei:
                tr.request(0, {"op": "stats"})
            assert "escalated after 2 attempt(s)" in str(ei.value)
            assert tr.counters["escalations"] == 1
        finally:
            tr.close()


# --------------------------------------------------------------------------
# the elastic trainer under chaos
# --------------------------------------------------------------------------


def _reference_init(jcfg):
    """The reference's initial fleet rows (``make_fleet``'s draw) and
    tower (``init_tower``), as numpy."""
    dense = np.asarray(jax.random.normal(
        jax.random.PRNGKey(jcfg.seed), (jcfg.vocab, jcfg.emb_dim))
        * 0.05, np.float32)
    tower = jw.init_tower(jcfg, jax.random.PRNGKey(jcfg.seed + 1))
    return dense, jax.tree.map(np.asarray, tower)


class TestCTRChaos:
    """Workload level: the acceptance pins, on the port's elastic CTR
    trainer (tower and dedup on the CPU here, on the card in
    ``chip_smoke.py``)."""

    KW = dict(steps=30, num_shards=3, optimizer="adagrad", mode="sync",
              device="cpu")

    @pytest.fixture(scope="class")
    def base(self):
        return tw.train_ctr_elastic(tw.CTRConfig(**CTR_SMALL), **self.KW)

    def test_masked_schedule_is_bit_exact(self, base):
        chaotic = tw.train_ctr_elastic(
            tw.CTRConfig(**CTR_SMALL), **self.KW, fault_schedule=MASK_SCHED,
            fault_seed=0)
        assert chaotic["injections"], "schedule never fired"
        assert chaotic["transport_counters"]["retries"] >= 1
        assert chaotic["losses"] == base["losses"]

    def test_single_crash_masked_by_replica_recovery(self, base):
        hit = tw.train_ctr_elastic(
            tw.CTRConfig(**CTR_SMALL), **self.KW, fault_seed=0,
            fault_schedule="crash,op=grad,shard=0,after=100,times=1")
        assert any(i["kind"] == "crash" for i in hit["injections"])
        assert any(e["kind"] == "recover" for e in hit["events"])
        assert hit["losses"] == base["losses"]

    def test_kill_both_replicas_without_checkpoint_is_fatal(self):
        with pytest.raises(PSUnrecoverable):
            tw.train_ctr_elastic(tw.CTRConfig(**CTR_SMALL), **self.KW,
                                 fault_schedule=KILL_BOTH, fault_seed=0)

    def test_kill_both_replicas_restores_bit_exact(self, base, tmp_path):
        """Correlated primary+backup loss mid-training restores the newest
        unified checkpoint and replays to the fault-free loss trajectory,
        bit for bit."""
        d = str(tmp_path / "ckpt")
        r = tw.train_ctr_elastic(
            tw.CTRConfig(**CTR_SMALL), **self.KW, fault_schedule=KILL_BOTH,
            fault_seed=0, ckpt_dir=d, ckpt_every=5)
        assert r["restores"] >= 1
        assert sum(i["kind"] == "crash" for i in r["injections"]) == 2
        assert [s for s, _ in r["checkpoints"]] == [4, 9, 14, 19, 24, 29]
        assert r["losses"] == base["losses"]
        assert any(e["kind"] == "restore" for e in r["events"])
        assert not [e for e in os.listdir(d) if ".tmp-" in e]
        latest = read_pointer(d)
        assert latest is not None and os.path.isdir(latest)

    @pytest.mark.parametrize("schedule", [MASK_SCHED, KILL_BOTH])
    def test_chaos_runs_follow_the_reference(self, schedule, tmp_path):
        """From the reference's table and tower, the port's chaos run
        stays within 1e-4 of the reference's losses, with the same
        injections, events, restores and checkpoints."""
        jcfg, cfg = jw.CTRConfig(**CTR_SMALL), tw.CTRConfig(**CTR_SMALL)
        kw = dict(self.KW, fault_schedule=schedule, fault_seed=0)
        del kw["device"]
        if schedule == KILL_BOTH:
            kw.update(ckpt_every=5)
        ref = jw.train_ctr_elastic(
            jcfg, **kw, **({"ckpt_dir": str(tmp_path / "ref")}
                           if schedule == KILL_BOTH else {}))
        dense, np_tower = _reference_init(jcfg)
        out = tw.train_ctr_elastic(
            cfg, **kw, device="cpu", dense=dense,
            tower=tw.tower_from_numpy(np_tower, cfg, device="cpu"),
            **({"ckpt_dir": str(tmp_path / "port")}
               if schedule == KILL_BOTH else {}))
        np.testing.assert_allclose(out["losses"], ref["losses"], rtol=0,
                                   atol=1e-4)
        assert out["injections"] == ref["injections"]
        assert [e["kind"] for e in out["events"]] == \
            [e["kind"] for e in ref["events"]]
        assert out["restores"] == ref["restores"]
        assert [s for s, _ in out["checkpoints"]] == \
            [s for s, _ in ref["checkpoints"]]


# --------------------------------------------------------------------------
# checkpoints
# --------------------------------------------------------------------------


def _push_rounds(fleet, rng, rounds=4):
    for _ in range(rounds):
        ids = rng.integers(0, VOCAB, size=16)
        fleet.push(ids, rng.normal(size=(16, DIM)).astype(np.float32),
                   lr=0.1)


class TestCheckpointAtomicity:
    def test_snapshot_restore_round_trip_bit_exact(self, tmp_path):
        rng = np.random.default_rng(0)
        fleet = _small_fleet()
        try:
            _push_rounds(fleet, rng)
            before = fleet.to_dense()
            snap = snapshot_fleet(fleet)
            save_fleet_checkpoint(str(tmp_path), 7, params={"w": before},
                                  snap=snap)
            params, snap2, step, _ = load_fleet_checkpoint(
                str(tmp_path), params_template={"w": torch.zeros_like(
                    before)})
            assert step == 7
            assert torch.equal(params["w"], before)
            fresh = _small_fleet()
            try:
                fresh.restore_snapshot(snap2)
                assert torch.equal(fresh.to_dense(), before)
                _assert_ownership_partition(fresh)
                # the restored optimizer state keeps training identical
                ids = np.arange(8)
                g = np.ones((8, DIM), np.float32)
                fleet.push(ids, g, lr=0.1)
                fresh.push(ids, g, lr=0.1)
                assert torch.equal(fresh.to_dense(), fleet.to_dense())
            finally:
                fresh.close()
        finally:
            fleet.close()

    def test_interrupted_save_is_never_selected(self, tmp_path):
        rng = np.random.default_rng(1)
        fleet = _small_fleet()
        try:
            _push_rounds(fleet, rng)
            snap = snapshot_fleet(fleet)
            dense = fleet.to_dense()
            save_fleet_checkpoint(str(tmp_path), 3, params={"w": dense},
                                  snap=snap)
            # a crash mid-write leaves a staging dir and no pointer flip
            orphan = tmp_path / "step-00000004.tmp-999"
            orphan.mkdir()
            (orphan / "manifest.json").write_text("{\"torn\":")
            assert [s for s, _ in list_checkpoints(str(tmp_path))] == [3]
            _, _, step, _ = load_fleet_checkpoint(
                str(tmp_path), params_template={"w": dense})
            assert step == 3
        finally:
            fleet.close()

    def test_prune_keeps_newest_and_sweeps_orphans(self, tmp_path):
        rng = np.random.default_rng(2)
        fleet = _small_fleet()
        try:
            dense = fleet.to_dense()
            (tmp_path / "step-00000009.tmp-1").mkdir()
            for step in (1, 2, 3, 4):
                _push_rounds(fleet, rng, rounds=1)
                save_fleet_checkpoint(
                    str(tmp_path), step, params={"w": dense},
                    snap=snapshot_fleet(fleet), keep=2)
            steps = [s for s, _ in list_checkpoints(str(tmp_path))]
            assert steps == [3, 4]
            assert not [e for e in os.listdir(tmp_path) if ".tmp-" in e]
            latest = read_pointer(str(tmp_path))
            assert latest and latest.endswith("step-00000004")
        finally:
            fleet.close()

    def test_checkpointer_cadence_and_order(self, tmp_path):
        rng = np.random.default_rng(3)
        fleet = _small_fleet()
        ckpt = FleetCheckpointer(fleet, str(tmp_path), every=3, keep=0)
        try:
            _push_rounds(fleet, rng, rounds=1)
            dense = {"w": torch.zeros((2, 2))}
            fired = [ckpt.maybe_save(i, dense) for i in range(9)]
            ckpt.wait()
            assert fired == [False, False, True] * 3
            assert [s for s, _ in ckpt.saved] == [2, 5, 8]
            assert [s for s, _ in list_checkpoints(str(tmp_path))] \
                == [2, 5, 8]
        finally:
            ckpt.close()
            fleet.close()

    def test_failed_background_write_surfaces(self, tmp_path):
        fleet = _small_fleet()
        blocker = tmp_path / "file"
        blocker.write_text("not a directory")
        ckpt = FleetCheckpointer(fleet, str(blocker / "ckpt"), every=1)
        try:
            ckpt.save(0, {"w": torch.zeros(2)})
            with pytest.raises(RuntimeError, match="write failed"):
                ckpt.wait()
        finally:
            ckpt.close()
            fleet.close()

    def test_restore_rejects_mismatched_geometry(self):
        fleet = _small_fleet()
        try:
            snap = snapshot_fleet(fleet)
            snap["meta"]["vocab"] = VOCAB + 1
            with pytest.raises(ValueError):
                fleet.restore_snapshot(snap)
            snap = snapshot_fleet(fleet)
            del snap["buckets"][2]
            with pytest.raises(ValueError, match="missing buckets"):
                fleet.restore_snapshot(snap)
        finally:
            fleet.close()


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_each_package_loads_the_others_fleet_checkpoint(writer, tmp_path):
    """One on-disk layout: a checkpoint written by either package restores
    the other's fleet bit for bit, optimizer state and acked counters
    included, and the tower comes back on its template."""
    dense = np.random.default_rng(6).normal(size=(VOCAB, DIM)).astype(
        np.float32)
    kw = dict(num_shards=3, num_buckets=6, optimizer="adam")
    ref = jel.ElasticPSFleet.from_dense(dense, **kw)
    port = ElasticPSFleet.from_dense(dense, device="cpu", **kw)
    tower = {"w": [np.arange(6, dtype=np.float32).reshape(2, 3)],
             "b": [np.ones(3, np.float32)]}
    try:
        for f in (ref, port):
            _push_rounds(f, np.random.default_rng(8))
        if writer == "reference":
            jsn.save_fleet_checkpoint(str(tmp_path), 5, params=tower,
                                      snap=jsn.snapshot_fleet(ref))
            src, dst = ref, _small_fleet(optimizer="adam")
            template = {k: [torch.zeros(a.shape) for a in v]
                        for k, v in tower.items()}
            params, snap, step, meta = load_fleet_checkpoint(
                str(tmp_path), params_template=template)
            assert torch.equal(params["w"][0],
                               torch.from_numpy(tower["w"][0]))
        else:
            save_fleet_checkpoint(
                str(tmp_path), 5, snap=snapshot_fleet(port),
                params={k: [torch.from_numpy(a) for a in v]
                        for k, v in tower.items()})
            src = port
            dst = jel.ElasticPSFleet(VOCAB, DIM, num_shards=3,
                                     num_buckets=6, optimizer="adam")
            params, snap, step, meta = jsn.load_fleet_checkpoint(
                str(tmp_path), params_template=tower)
            assert np.array_equal(np.asarray(params["w"][0]),
                                  tower["w"][0])
        assert step == 5 and meta["ps"]["optimizer"] == "adam"
        try:
            dst.restore_snapshot(snap)
            assert np.array_equal(np.asarray(dst.to_dense()),
                                  np.asarray(src.to_dense()))
            ids = np.arange(VOCAB)
            g = np.ones((VOCAB, DIM), np.float32)
            for f in (src, dst):
                f.push(ids, g, lr=0.1)
            assert np.array_equal(np.asarray(dst.to_dense()),
                                  np.asarray(src.to_dense()))
        finally:
            dst.close()
    finally:
        ref.close()
        port.close()


def test_restored_tower_lands_on_the_templates_device(tmp_path):
    fleet = _small_fleet()
    try:
        w = torch.arange(4.0).reshape(2, 2)
        save_fleet_checkpoint(str(tmp_path), 1, params={"w": [w]},
                              snap=snapshot_fleet(fleet))
        params, _, _, _ = load_fleet_checkpoint(
            str(tmp_path), params_template={"w": [torch.zeros(
                2, 2, dtype=torch.float64)]})
        assert params["w"][0].dtype == torch.float64
        assert params["w"][0].device == torch.device("cpu")
        assert torch.equal(params["w"][0], w.double())
    finally:
        fleet.close()


# --------------------------------------------------------------------------
# detection over real worker processes
# --------------------------------------------------------------------------


class TestHungVsDeadMultiproc:
    def test_hung_worker_escalates_with_context(self):
        tr = MultiprocTransport(
            request_timeout=0.5, heartbeat_s=None,
            retry=RetryPolicy(max_attempts=2, backoff_s=0.01))
        tr.add_shard(0, dim=DIM)
        try:
            pid = tr._shards[0].proc.pid
            os.kill(pid, signal.SIGSTOP)
            try:
                with pytest.raises(PSShardLost) as ei:
                    tr.request(0, {"op": "stats"})
            finally:
                try:
                    os.kill(pid, signal.SIGCONT)
                except ProcessLookupError:
                    pass
            msg = str(ei.value)
            assert "op='stats'" in msg and "process alive" in msg
            assert tr.counters["retries"] >= 1
            assert tr.counters["escalations"] == 1
        finally:
            tr.close()

    def test_dead_worker_reports_exitcode(self):
        tr = MultiprocTransport(heartbeat_s=None)
        tr.add_shard(0, dim=DIM)
        try:
            os.kill(tr._shards[0].proc.pid, signal.SIGKILL)
            time.sleep(0.1)
            with pytest.raises(PSShardLost) as ei:
                tr.request(0, {"op": "stats"})
            assert "exitcode=-9" in str(ei.value)
        finally:
            tr.close()

    def test_heartbeat_detects_death_without_traffic(self):
        lost = []
        tr = MultiprocTransport(heartbeat_s=0.1)
        tr.on_shard_lost = lost.append
        tr.add_shard(0, dim=DIM)
        tr.add_shard(1, dim=DIM)
        try:
            os.kill(tr._shards[0].proc.pid, signal.SIGKILL)
            deadline = time.monotonic() + 5.0
            while 0 in tr.live_shards and time.monotonic() < deadline:
                time.sleep(0.02)
            assert 0 not in tr.live_shards, "heartbeat never noticed"
            assert lost == [0]
            assert tr.counters["heartbeat_misses"] >= 1
            assert 1 in tr.live_shards
        finally:
            tr.close()

    def test_intentional_removal_never_fires_callback(self):
        lost = []
        tr = MultiprocTransport(heartbeat_s=0.05)
        tr.on_shard_lost = lost.append
        for s in (0, 1):
            tr.add_shard(s, dim=DIM)
        try:
            tr.stop_shard(0)
            tr.kill_shard(1)
            time.sleep(0.3)   # several heartbeat periods
            assert lost == []
        finally:
            tr.close()

    def test_crash_through_the_injector_kills_the_worker(self):
        tr = FaultInjector(MultiprocTransport(heartbeat_s=None),
                           "crash,op=stats,times=1", seed=0)
        tr.add_shard(0, dim=DIM)
        try:
            proc = tr.inner._shards[0].proc
            with pytest.raises(PSShardLost):
                tr.request(0, {"op": "stats"})
            proc.join(5.0)
            assert not proc.is_alive() and 0 not in tr.live_shards
        finally:
            tr.close()


# --------------------------------------------------------------------------
# the health bridge against the real fleet
# --------------------------------------------------------------------------


def test_fleet_health_reflects_degradation_as_the_reference():
    dense = np.zeros((VOCAB, DIM), np.float32)
    kw = dict(num_shards=3, num_buckets=6, optimizer="adagrad")
    fleets = {"port": (ElasticPSFleet.from_dense(dense, device="cpu", **kw),
                       tbr, T_CPU),
              "ref": (jel.ElasticPSFleet.from_dense(dense, **kw), jbr,
                      J_CPU)}
    seen = {}
    try:
        for name, (fleet, bridge, cpu) in fleets.items():
            h0 = bridge.fleet_health(fleet)
            assert not h0["degraded"] and h0["dead_shards"] == []
            fleet.kill(0)
            h1 = bridge.fleet_health(fleet)
            assert h1["degraded"] and h1["dead_shards"] == [0]
            snap = bridge.snapshot_resources(cpu, fleet=fleet)
            assert snap["ps_health"]["degraded"]
            fleet.recover()
            h2 = bridge.fleet_health(fleet)
            assert not h2["degraded"]
            assert h2["events"]["recover"] >= 1
            seen[name] = (h0, h1, h2)
    finally:
        for fleet, _, _ in fleets.values():
            fleet.close()
    assert seen["port"] == seen["ref"]


# --------------------------------------------------------------------------
# random schedules
# --------------------------------------------------------------------------


class TestChaosProperty:
    """Random interleaved fault schedules vs the elastic fleet —
    post-recovery pulls bit-exact vs a fault-free oracle, ownership stays
    a partition."""

    ROUNDS = 10

    def _run(self, schedule, seed):
        rng = np.random.default_rng(seed)
        transport = (FaultInjector(InProcTransport(), schedule, seed=seed)
                     if schedule is not None else None)
        fleet = ElasticPSFleet(VOCAB, DIM, num_shards=3, num_buckets=6,
                               optimizer="adagrad", transport=transport,
                               device="cpu")
        try:
            for _ in range(self.ROUNDS):
                ids = rng.integers(0, VOCAB, size=16)
                fleet.push(ids,
                           rng.normal(size=(16, DIM)).astype(np.float32),
                           lr=0.1)
                fleet.pull(ids[:4])
            if schedule is not None:
                # retire the schedule: the property is about state AFTER
                # the chaos window
                fleet.transport.rules.clear()
            pulled = fleet.pull(np.arange(VOCAB)).numpy()
            _assert_ownership_partition(fleet)
            fired = (list(fleet.transport.injections)
                     if schedule is not None else [])
            return pulled, fleet.to_dense().numpy(), fired
        finally:
            fleet.close()

    @settings(max_examples=8, deadline=None)
    @given(
        st.integers(min_value=0, max_value=10_000),
        st.lists(st.sampled_from(["delay", "drop_reply", "dup_reply",
                                  "recv_error", "crash"]),
                 min_size=1, max_size=5),
    )
    def test_random_schedules_keep_state_bit_exact(self, seed, kinds):
        rng = np.random.default_rng(seed ^ 0xC0FFEE)
        rules, crashed = [], False
        for kind in kinds:
            if kind == "crash":
                if crashed:    # a second crash could take both replicas
                    continue
                crashed = True
            rules.append(FaultRule(
                kind, after=int(rng.integers(20, 120)), times=1,
                shard=(int(rng.integers(0, 3)) if kind == "crash"
                       else None),
                delay_s=0.0005 if kind == "delay" else 0.0))
        oracle_pull, oracle_dense, _ = self._run(None, seed)
        pull, dense, fired = self._run(rules, seed)
        np.testing.assert_array_equal(pull, oracle_pull)
        np.testing.assert_array_equal(dense, oracle_dense)
        for rule in rules:
            assert sum(1 for f in fired if f["kind"] == rule.kind) \
                <= sum(r.times for r in rules if r.kind == rule.kind)
