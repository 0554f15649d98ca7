"""The port's elastic PS fleet (``repro_torch.ps.elastic``) against the
JAX reference's (``repro.ps.elastic``) on the CPU.

Two kinds of check:

* the reference's own invariants (``tests/test_ps_elastic.py``), run on
  the port: ownership stays a partition after any join/leave/kill
  sequence, a pull against a migrating range misses at most
  ``staleness_bound`` updates, a promoted replica is bit-exact, and a
  kill + recovery mid-training leaves the loss trajectory bit-equal;
* the two packages side by side: the same dense table and the same numpy
  pushes give bit-equal slabs, optimizer state, acked counters and
  ownership maps after join, migrate and kill/recover, for sgd, adagrad
  and adam (the push's dedup adds duplicates in stream order in both);
  ``train_ctr_elastic`` from the reference's table and tower stays within
  1e-4 of the reference's losses (float32 towers in two libraries), with
  the same fleet events.
"""

from __future__ import annotations

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

from repro.ps import elastic as jel
from repro.ps import workload as jw
from repro_torch.ps import elastic as tel
from repro_torch.ps import workload as tw
from repro_torch.ps.transport import MultiprocTransport, PSShardLost

VOCAB, DIM = 97, 4
HARD_TIMEOUT_S = 120
#: the reference's CTR pin config (tests/test_ps_elastic.py)
CTR_SMALL = dict(vocab=5_000, emb_dim=8, slots=8, tower=(32,), batch=64)


@pytest.fixture(autouse=True)
def hard_timeout():
    """SIGALRM ceiling: a wedged shard process fails the test instead of
    wedging the runner."""
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


def _fleet(**kw):
    kw.setdefault("device", "cpu")
    return tel.ElasticPSFleet(VOCAB, DIM, **kw)


def _push_some(fleet, rng, n=16, lr=0.1):
    ids = rng.integers(0, VOCAB, size=n)
    fleet.push(ids, rng.normal(size=(n, DIM)).astype(np.float32), lr=lr)
    return ids


def _assert_ownership_partition(fleet):
    """Every bucket: exactly one live primary, hosted server-side; the
    buckets' rows partition the vocab."""
    stats = fleet.stats()
    live = set(stats["live_shards"])
    hosted = {s: set(rep["buckets"]) for s, rep in stats["shards"].items()}
    total_rows = 0
    for b in range(fleet.spec.num_buckets):
        p = stats["primary"][b]
        assert p in live, f"bucket {b} primary {p} is not live"
        assert b in hosted[p], f"shard {p} does not host its bucket {b}"
        k = stats["backup"][b]
        if k >= 0:
            assert k in live and k != p
            assert b in hosted[k]
        total_rows += fleet.spec.rows_in(b)
    assert total_rows == fleet.spec.vocab


# --------------------------------------------------------------------------
# the reference's invariants, on the port
# --------------------------------------------------------------------------


class TestBucketSpec:
    @settings(max_examples=25, deadline=None)
    @given(st.integers(min_value=1, max_value=VOCAB))
    def test_buckets_partition_vocab_as_the_reference(self, num_buckets):
        spec = tel.BucketSpec(VOCAB, DIM, num_buckets)
        ref = jel.BucketSpec(VOCAB, DIM, num_buckets)
        seen = np.concatenate([spec.global_rows(b)
                               for b in range(num_buckets)])
        assert np.array_equal(np.sort(seen), np.arange(VOCAB))
        ids = np.arange(VOCAB)
        owners = spec.bucket_of(ids)
        assert np.array_equal(owners, ref.bucket_of(ids))
        assert np.array_equal(spec.local(ids), ref.local(ids))
        for b in range(num_buckets):
            assert np.array_equal(ids[owners == b], spec.global_rows(b))
            assert spec.rows_in(b) == ref.rows_in(b)

    def test_bad_bucket_counts_rejected(self):
        for nb in (0, VOCAB + 1):
            with pytest.raises(ValueError, match="num_buckets"):
                tel.BucketSpec(VOCAB, DIM, nb)


class TestReshardingInvariants:
    @settings(max_examples=10, deadline=None)
    @given(
        st.integers(min_value=0, max_value=10_000),
        st.lists(st.sampled_from(["join", "leave", "kill"]),
                 min_size=1, max_size=6),
    )
    def test_ownership_partition_after_any_sequence(self, seed, events):
        rng = np.random.default_rng(seed)
        fleet = _fleet(num_shards=3, num_buckets=8, optimizer="sgd")
        try:
            for ev in events:
                _push_some(fleet, rng)
                live = sorted(fleet.transport.live_shards)
                if ev == "join":
                    fleet.join()
                elif ev == "leave" and len(live) > 2:
                    fleet.leave(int(rng.choice(live)))
                elif ev == "kill" and len(live) > 2:
                    fleet.kill(int(rng.choice(live)))
                    fleet.recover()
                _push_some(fleet, rng)
                _assert_ownership_partition(fleet)
            assert fleet.to_dense().shape == (VOCAB, DIM)
        finally:
            fleet.close()

    @settings(max_examples=10, deadline=None)
    @given(st.integers(min_value=0, max_value=10_000))
    def test_state_unchanged_by_elasticity(self, seed):
        """The same push stream lands bit-identically whether or not the
        fleet reshapes mid-stream — elasticity is invisible to values."""
        def run(with_events):
            rng = np.random.default_rng(seed)
            fleet = _fleet(num_shards=3, num_buckets=8, optimizer="adagrad")
            try:
                for i in range(8):
                    _push_some(fleet, rng)
                    if with_events and i == 2:
                        fleet.join()
                    if with_events and i == 5:
                        fleet.kill(0)
                        fleet.recover()
                return fleet.to_dense().numpy()
            finally:
                fleet.close()

        assert np.array_equal(run(True), run(False))


class TestBoundedStaleness:
    @settings(max_examples=10, deadline=None)
    @given(
        st.integers(min_value=0, max_value=5),
        st.integers(min_value=1, max_value=12),
    )
    def test_pull_never_staler_than_bound(self, bound, n_pushes):
        fleet = _fleet(num_shards=2, num_buckets=4, optimizer="sgd",
                       staleness_bound=bound)
        try:
            sid = fleet.join(rebalance=False)
            fleet.begin_migration(0, sid)
            lr = 0.5
            ids = np.arange(min(5, fleet.spec.bucket_rows))
            for i in range(n_pushes):
                fleet.push(ids, np.ones((ids.size, DIM), np.float32), lr=lr)
                assert fleet.migration_staleness(0) <= bound
                seen = float(fleet.pull(ids[:1])[0, 0])
                true = -lr * (i + 1)
                missed = round((seen - true) / lr)
                assert 0 <= missed <= bound, (seen, true, missed)
            assert fleet.migration_backlog(0) == n_pushes
            fleet.finish_migration(0)
            assert fleet.migration_backlog(0) == 0
            seen = float(fleet.pull(ids[:1])[0, 0])
            assert abs(seen - (-lr * n_pushes)) < 1e-5
            assert fleet.owners()[0][0] == sid
        finally:
            fleet.close()


class TestLosslessRecovery:
    @settings(max_examples=10, deadline=None)
    @given(
        st.integers(min_value=0, max_value=10_000),
        st.sampled_from(["sgd", "adagrad", "adam"]),
    )
    def test_promoted_replica_is_bit_exact(self, seed, optimizer):
        rng = np.random.default_rng(seed)
        fleet = _fleet(num_shards=3, num_buckets=6, optimizer=optimizer)
        try:
            for _ in range(5):
                _push_some(fleet, rng, lr=0.05)
            before = fleet.to_dense().numpy()
            victim = int(rng.choice(sorted(fleet.transport.live_shards)))
            fleet.kill(victim)
            # next touch triggers recovery transparently
            after_pull = fleet.pull(np.arange(VOCAB)).numpy()
            assert np.array_equal(before, fleet.to_dense().numpy())
            assert np.array_equal(before, after_pull)
            assert [e["kind"] for e in fleet.events][-2:] == ["kill",
                                                              "recover"]
            _assert_ownership_partition(fleet)
        finally:
            fleet.close()

    def test_losing_both_replicas_is_unrecoverable(self):
        fleet = _fleet(num_shards=2, num_buckets=4, optimizer="sgd")
        try:
            fleet.kill(0)
            fleet.kill(1)
            with pytest.raises(tel.PSUnrecoverable):
                fleet.recover()
        finally:
            fleet.close()

    def test_no_replicas_means_no_recovery(self):
        fleet = _fleet(num_shards=2, num_buckets=4, optimizer="sgd",
                       replicas=0)
        try:
            fleet.kill(0)
            with pytest.raises(tel.PSUnrecoverable, match="no backup"):
                fleet.recover()
        finally:
            fleet.close()

    @pytest.mark.parametrize("kwargs,match", [
        ({"optimizer": "none"}, "fleet optimizer"),
        ({"optimizer": "lamb"}, "fleet optimizer"),
        ({"replicas": 2}, "replicas"),
        ({"num_shards": 0}, "num_shards"),
    ])
    def test_bad_arguments_rejected(self, kwargs, match):
        with pytest.raises(ValueError, match=match):
            _fleet(**kwargs)


class TestDevice:
    def test_pull_is_float32_on_the_fleets_device(self):
        fleet = tel.ElasticPSFleet.from_dense(
            np.arange(VOCAB * DIM, dtype=np.float32).reshape(VOCAB, DIM),
            num_shards=2, device="cpu")
        try:
            ids = np.array([[3, 96], [0, 50]], np.int32)
            for given_ids in (ids, torch.from_numpy(ids)):
                rows = fleet.pull(given_ids)
                assert rows.dtype == torch.float32
                assert rows.device == torch.device("cpu")
                assert rows.shape == (2, 2, DIM)
                assert np.array_equal(rows[0, 1].numpy(),
                                      np.arange(96 * DIM, 97 * DIM))
            with pytest.raises(ValueError, match="out of range"):
                fleet.pull(np.array([VOCAB]))
        finally:
            fleet.close()

    def test_fleet_defaults_to_cuda(self):
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present: the default is usable")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tel.ElasticPSFleet(VOCAB, DIM)

    def test_seeded_rows_are_the_torch_generators(self):
        fleet = _fleet(num_shards=2, seed=3, init_scale=0.05)
        try:
            g = torch.Generator().manual_seed(3)
            want = torch.randn((VOCAB, DIM), generator=g) * 0.05
            assert torch.equal(fleet.to_dense(), want)
        finally:
            fleet.close()


# --------------------------------------------------------------------------
# the two packages side by side
# --------------------------------------------------------------------------

#: (name, fleet actions between rounds of pushes)
SEQUENCES = {
    "join": [("join",)],
    "migrate": [("migrate", 0, 2), ("migrate", 5, 1)],
    "kill": [("kill", 1)],
    "join+kill+leave": [("join",), ("kill", 0), ("leave", 2)],
}


def _apply(fleet, action):
    if action[0] == "join":
        fleet.join()
    elif action[0] == "migrate":
        fleet.migrate(*action[1:])
    elif action[0] == "kill":
        fleet.kill(action[1])
        fleet.recover()
    else:
        fleet.leave(action[1])


def _drive(fleet, actions, seed, *, lr=0.05):
    """Rounds of the same numpy pushes (duplicates included) with the
    actions in between; returns every bucket's primary snapshot."""
    rng = np.random.default_rng(seed)
    for step in range(len(actions) + 1):
        for _ in range(3):
            ids = rng.integers(0, VOCAB, size=(4, 6)).astype(np.int32)
            g = rng.normal(size=(4, 6, DIM)).astype(np.float32)
            fleet.push(ids, g, lr=lr)
        if step < len(actions):
            _apply(fleet, actions[step])
    return [fleet.transport.request(int(fleet.primary[b]),
                                    {"op": "snapshot", "bucket": b})
            for b in range(fleet.spec.num_buckets)]


@pytest.mark.parametrize("sequence", sorted(SEQUENCES))
@pytest.mark.parametrize("optimizer", ["sgd", "adagrad", "adam"])
def test_fleet_state_equals_the_reference(optimizer, sequence):
    dense = np.random.default_rng(11).normal(
        size=(VOCAB, DIM)).astype(np.float32) * 0.1
    kw = dict(num_shards=3, num_buckets=6, optimizer=optimizer)
    ref = jel.ElasticPSFleet.from_dense(dense, **kw)
    port = tel.ElasticPSFleet.from_dense(dense, device="cpu", **kw)
    try:
        actions = SEQUENCES[sequence]
        jsnaps = _drive(ref, actions, seed=5)
        tsnaps = _drive(port, actions, seed=5)
        assert np.array_equal(port.to_dense().numpy(),
                              np.asarray(ref.to_dense()))
        for b, (t, j) in enumerate(zip(tsnaps, jsnaps)):
            assert np.array_equal(t["rows"], j["rows"]), f"bucket {b}"
            assert t["acked"] == j["acked"], f"bucket {b}"
            assert sorted(t["opt"]) == sorted(j["opt"])
            for k in t["opt"]:
                assert np.array_equal(t["opt"][k], j["opt"][k]), (b, k)
        for a, b in zip(port.owners(), ref.owners()):
            assert np.array_equal(a, b)
        assert [e["kind"] for e in port.events] == \
            [e["kind"] for e in ref.events]
        ids = np.arange(VOCAB)
        assert np.array_equal(port.pull(ids).numpy(),
                              np.asarray(ref.pull(ids)))
    finally:
        ref.close()
        port.close()


@pytest.mark.parametrize("bound", [0, 2])
def test_migrating_pulls_equal_the_reference(bound):
    """Bounded staleness is the same staleness in both: every pull of a
    migrating range returns the reference's bits."""
    dense = np.zeros((VOCAB, DIM), np.float32)
    kw = dict(num_shards=2, num_buckets=4, optimizer="adagrad",
              staleness_bound=bound)
    fleets = (jel.ElasticPSFleet.from_dense(dense, **kw),
              tel.ElasticPSFleet.from_dense(dense, device="cpu", **kw))
    try:
        seen = []
        for f in fleets:
            rng = np.random.default_rng(1)
            sid = f.join(rebalance=False)
            f.begin_migration(0, sid)
            rows = []
            for _ in range(5):
                ids = rng.integers(0, 30, size=12)
                f.push(ids, rng.normal(size=(12, DIM)).astype(np.float32),
                       lr=0.1)
                rows.append(np.asarray(f.pull(np.arange(30))))
            f.finish_migration(0)
            rows.append(np.asarray(f.pull(np.arange(VOCAB))))
            seen.append(rows)
        for j, t in zip(*seen):
            assert np.array_equal(j, t)
    finally:
        for f in fleets:
            f.close()


def test_push_without_dedup_equals_the_reference():
    dense = np.random.default_rng(2).normal(size=(VOCAB, DIM)).astype(
        np.float32)
    kw = dict(num_shards=2, optimizer="sgd")
    ref = jel.ElasticPSFleet.from_dense(dense, **kw)
    port = tel.ElasticPSFleet.from_dense(dense, device="cpu", **kw)
    try:
        rng = np.random.default_rng(3)
        ids = rng.integers(0, VOCAB, size=40)
        g = rng.normal(size=(40, DIM)).astype(np.float32)
        ref.push(ids, g, lr=0.3, dedup=False)
        port.push(ids, torch.from_numpy(g), lr=0.3, dedup=False)
        assert np.array_equal(port.to_dense().numpy(),
                              np.asarray(ref.to_dense()))
    finally:
        ref.close()
        port.close()


def _reference_init(jcfg):
    """The reference's initial fleet rows (``make_fleet``'s draw) and
    tower (``init_tower``), as numpy."""
    dense = np.asarray(jax.random.normal(
        jax.random.PRNGKey(jcfg.seed), (jcfg.vocab, jcfg.emb_dim))
        * 0.05, np.float32)
    tower = jw.init_tower(jcfg, jax.random.PRNGKey(jcfg.seed + 1))
    return dense, jax.tree.map(np.asarray, tower)


@pytest.mark.parametrize("optimizer,events", [
    ("sgd", [(10, "join", None), (20, "kill", 0)]),
    ("adagrad", [(8, "leave", 1), (15, "join", None)]),
    ("adam", [(12, "kill", 2)]),
])
def test_elastic_training_follows_the_reference(optimizer, events):
    jcfg, cfg = jw.CTRConfig(**CTR_SMALL), tw.CTRConfig(**CTR_SMALL)
    kw = dict(steps=25, num_shards=3, optimizer=optimizer, mode="sync",
              events=events)
    ref = jw.train_ctr_elastic(jcfg, **kw)
    dense, np_tower = _reference_init(jcfg)
    # the reference's fleet starts from exactly these rows
    jf = jw.make_fleet(jcfg, 3)
    try:
        assert np.array_equal(np.asarray(jf.to_dense()), dense)
    finally:
        jf.close()
    out = tw.train_ctr_elastic(
        cfg, **kw, device="cpu", dense=dense,
        tower=tw.tower_from_numpy(np_tower, cfg, device="cpu"))
    np.testing.assert_allclose(out["losses"], ref["losses"], rtol=0,
                               atol=1e-4)
    assert [e["kind"] for e in out["events"]] == \
        [e["kind"] for e in ref["events"]]
    assert out["live_shards"] == ref["live_shards"]
    assert out["devices"] == {"tower": ["cpu"]}
    for key in ref:
        assert key in out, key


class TestCTRConvergencePin:
    def test_kill_recovery_matches_uninterrupted_trajectory(self):
        """A shard kill + replica recovery during CTR training gives the
        same loss trajectory as the uninterrupted run, bit for bit (sync
        replication and a deterministic PS-hosted optimizer)."""
        cfg = tw.CTRConfig(**CTR_SMALL)
        kw = dict(steps=40, num_shards=3, optimizer="sgd", mode="sync",
                  device="cpu")
        calm = tw.train_ctr_elastic(cfg, **kw)
        hit = tw.train_ctr_elastic(
            cfg, **kw, events=[(10, "join", None), (20, "kill", 0)])
        assert sum(e["kind"] == "recover" for e in hit["events"]) == 1
        assert hit["live_shards"] != calm["live_shards"]
        assert hit["losses"] == calm["losses"]
        assert hit["recovery_seconds"] > 0 and hit["join_seconds"] > 0
        assert np.mean(calm["losses"][-8:]) < np.mean(calm["losses"][:8])

    def test_async_mode_survives_the_same_events(self):
        cfg = tw.CTRConfig(**CTR_SMALL)
        out = tw.train_ctr_elastic(
            cfg, steps=30, num_shards=3, optimizer="adam", mode="async",
            device="cpu", events=[(10, "join", None), (20, "kill", 0)])
        assert out["steps"] == 30
        assert all(np.isfinite(out["losses"]))
        # the puller and the pusher may both trip over the dead shard:
        # the second recovery is a no-op that still logs an event
        recovers = [e for e in out["events"] if e["kind"] == "recover"]
        assert 1 <= len(recovers) <= 2
        assert all(e["shards"] == [0] for e in recovers)

    def test_unknown_event_and_mode_rejected(self):
        cfg = tw.CTRConfig(**CTR_SMALL)
        with pytest.raises(ValueError, match="unknown fleet event"):
            tw.train_ctr_elastic(cfg, steps=3, device="cpu",
                                 events=[(1, "explode", None)])
        with pytest.raises(ValueError, match="sync|async"):
            tw.train_ctr_elastic(cfg, steps=1, mode="turbo", device="cpu")
        with pytest.raises(ValueError, match="requires mode='sync'"):
            tw.train_ctr_elastic(cfg, steps=1, mode="async", device="cpu",
                                 ckpt_dir="unused", ckpt_every=2)


# --------------------------------------------------------------------------
# real shard processes
# --------------------------------------------------------------------------


def test_multiproc_fleet_kill_matches_inproc():
    """One process per shard: the same pushes, a join and a hard kill of
    a worker give the in-process fleet's state bit for bit."""
    dense = np.random.default_rng(4).normal(size=(VOCAB, DIM)).astype(
        np.float32)
    states = []
    for transport in ("inproc", "multiproc"):
        fleet = tel.ElasticPSFleet.from_dense(
            dense, num_shards=3, num_buckets=6, optimizer="adagrad",
            transport=transport, device="cpu")
        try:
            rng = np.random.default_rng(9)
            for i in range(6):
                _push_some(fleet, rng)
                if i == 1:
                    fleet.join()
                if i == 3:
                    fleet.kill(0)
            states.append((fleet.pull(np.arange(VOCAB)).numpy(),
                           [e["kind"] for e in fleet.events]))
            _assert_ownership_partition(fleet)
        finally:
            fleet.close()
    assert np.array_equal(states[0][0], states[1][0])
    assert states[0][1] == states[1][1]
    assert "recover" in states[1][1]


def test_heartbeat_recovers_the_fleet_without_traffic():
    """A worker SIGKILLed while no request is in flight: the heartbeat
    thread calls the fleet's ``_on_lost``, which recovers (taking the
    fleet lock) before the next pull; the rows are the last acked
    state."""
    tr = MultiprocTransport(heartbeat_s=0.1)
    fleet = tel.ElasticPSFleet(VOCAB, DIM, num_shards=3, num_buckets=6,
                               optimizer="sgd", transport=tr, seed=0,
                               device="cpu")
    try:
        _push_some(fleet, np.random.default_rng(0))
        before = fleet.to_dense().numpy()
        os.kill(tr._shards[1].proc.pid, signal.SIGKILL)
        deadline = time.monotonic() + 10.0
        while (not any(e["kind"] == "recover" for e in fleet.events)
               and time.monotonic() < deadline):
            time.sleep(0.02)
        kinds = [e["kind"] for e in fleet.events]
        assert kinds[:2] == ["detected", "recover"], kinds
        assert 1 not in tr.live_shards
        assert np.array_equal(fleet.pull(np.arange(VOCAB)).numpy(), before)
        _assert_ownership_partition(fleet)
    finally:
        fleet.close()


def test_migration_to_a_dead_shard_raises():
    fleet = _fleet(num_shards=2)
    try:
        with pytest.raises(PSShardLost):
            fleet.migrate(0, 7)
    finally:
        fleet.close()
