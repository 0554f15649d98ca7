"""The port's CTR-over-parameter-server path (``repro_torch.ps``,
``repro_torch.parallel.ps``, ``repro_torch.data.cache`` and the
``--sparse-ps`` launcher) against the JAX reference on the CPU.

Ids, gradients and tables come from numpy seeds and go to both packages
as the same values.  The load-bearing invariant is bit-exactness: the
sharded pull/push equals the single-array oracle and the reference's
table for random id streams, hot cache included (a routing, dedup or
write-through change that moves one mantissa bit fails here).  The dense
tower is held against the reference's ``make_step_fn`` at rtol 1e-5
(float32 matmuls in two libraries), and a 25-step sync training run,
started from the reference's table and tower, at atol 1e-4 on every
step's loss and 1e-5 on the final table (the tower's rounding feeds the
pushed gradients).
"""

from __future__ import annotations

import dataclasses
import signal
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.resources import CPU_CORE as J_CPU
from repro.data import AccessMonitor as JMonitor
from repro.data import TierThresholds as JThresholds
from repro.parallel import ps as jpps
from repro.ps import workload as jw
from repro.ps.placement import TierPlacer as JPlacer
from repro.ps.sharding import RoutingSpec as JSpec
from repro.ps.sharding import ShardedTable as JTable
from repro.ps.telemetry import PSTelemetry as JTelemetry
from repro_torch.core.resources import CPU_CORE as T_CPU
from repro_torch.data import AccessMonitor, Tier, TierThresholds
from repro_torch.launch import train as ttrain
from repro_torch.parallel import ps as tpps
from repro_torch.ps import (
    CTRConfig, PSClient, PSTelemetry, RoutingSpec, ShardedTable, TierPlacer,
    make_step_fn, make_table, sharded_pull, sharded_update, tower_from_numpy,
    train_ctr_ps,
)
from repro_torch.ps import workload as tw

ROOT = Path(__file__).resolve().parent.parent
VOCAB, DIM = 101, 8
SHARD_CASES = [(s, p) for s in (1, 3, 4) for p in ("mod", "block")]
#: the reference's workload test config (tests/test_ps.py)
SMALL = dict(vocab=2000, emb_dim=8, slots=6, tower=(32,), batch=64, lr=0.1)


def _ids(n=91, seed=0, vocab=VOCAB):
    return np.random.default_rng(seed).integers(
        0, vocab, (7, n // 7)).astype(np.int32)


def _grads(ids, seed=1):
    return np.random.default_rng(seed).standard_normal(
        (*ids.shape, DIM)).astype(np.float32)


@pytest.fixture(scope="module")
def dense():
    return np.random.default_rng(42).standard_normal(
        (VOCAB, DIM)).astype(np.float32)


def _cpu_table(dense, shards, **kw):
    return ShardedTable.from_dense(dense, shards, device="cpu", **kw)


# --------------------------------------------------------------------------
# routing
# --------------------------------------------------------------------------


@pytest.mark.parametrize("shards,partition", SHARD_CASES)
def test_routing_spec_equals_the_reference(shards, partition):
    t, j = (RoutingSpec(VOCAB, DIM, shards, partition),
            JSpec(VOCAB, DIM, shards, partition))
    assert (t.block, t.shard_rows, t.offsets) == (j.block, j.shard_rows,
                                                  j.offsets)
    for s in range(shards):
        assert np.array_equal(t.global_rows(s), j.global_rows(s))
    ids = np.arange(VOCAB, dtype=np.int32)
    want_owner, want_local = (np.asarray(a) for a in j.route(jnp.asarray(ids)))
    want_flat = np.asarray(j.flatten(jnp.asarray(ids)))
    for got_route, got_flat in (
            (t.route(ids), t.flatten(ids)),
            (t.route(torch.from_numpy(ids)), t.flatten(torch.from_numpy(ids)))):
        assert np.array_equal(np.asarray(got_route[0]), want_owner)
        assert np.array_equal(np.asarray(got_route[1]), want_local)
        assert np.array_equal(np.asarray(got_flat), want_flat)


def test_routing_spec_rejects_bad_args():
    with pytest.raises(ValueError, match="partition"):
        RoutingSpec(VOCAB, DIM, 4, "hash")
    with pytest.raises(ValueError, match="num_shards"):
        RoutingSpec(4, DIM, 8)


# --------------------------------------------------------------------------
# the table against its own oracle and against the reference's table
# --------------------------------------------------------------------------


def _shard_major(t: ShardedTable) -> torch.Tensor:
    return torch.cat(t.shards)


@pytest.mark.parametrize("dedup", [False, True])
@pytest.mark.parametrize("shards,partition", SHARD_CASES)
def test_table_equals_its_single_array_oracle(dense, shards, partition,
                                              dedup):
    """pull == sharded_pull and push == sharded_update (shard-major storage,
    with a hot cache on the oracle side), bit for bit."""
    t = _cpu_table(dense, shards, partition=partition, hot_capacity=8)
    try:
        data = _shard_major(t)
        for seed in range(3):
            ids, g = _ids(seed=seed), _grads(_ids(seed=seed), seed=seed + 7)
            ti = torch.from_numpy(ids)
            got = t.pull(ids)
            want = sharded_pull(data, t.hot_rows, t.slot_of, ti, spec=t.spec)
            assert torch.equal(got, want)
            if seed == 0:
                assert torch.equal(got, torch.from_numpy(dense)[ti.long()])
            t.push(ids, g, lr=0.1, dedup=dedup)
            data, _, _ = sharded_update(data, ti, torch.from_numpy(g), 0.1,
                                        spec=t.spec, dedup=dedup)
            assert torch.equal(_shard_major(t), data)
            if seed == 0:
                t.install_hot_rows(np.arange(3, 11))
        assert t.hot_pulls == 2
    finally:
        t.close()


@pytest.mark.parametrize("shards,partition", SHARD_CASES)
def test_table_equals_the_reference_table(dense, shards, partition):
    """The same dense table in both packages, a sequence of pulls and
    pushes (with and without dedup) and one re-pin: every pulled row and
    the final table bit-equal."""
    r = np.random.default_rng(shards)
    t = _cpu_table(dense, shards, partition=partition, hot_capacity=16)
    j = JTable.from_dense(jnp.asarray(dense), shards, partition=partition,
                          hot_capacity=16)
    try:
        for step in range(5):
            ids = r.integers(0, 40, (6, 9)).astype(np.int32)
            g = r.standard_normal((6, 9, DIM)).astype(np.float32)
            assert np.array_equal(t.pull(ids).numpy(), np.asarray(j.pull(ids)))
            t.push(ids, g, lr=0.05 * (step + 1), dedup=bool(step % 2))
            j.push(ids, g, lr=0.05 * (step + 1), dedup=bool(step % 2))
            if step == 1:
                hot = r.permutation(40)[:12]
                assert t.install_hot_rows(hot) == j.install_hot_rows(hot)
        assert np.array_equal(t.hot_rows.numpy(), np.asarray(j.hot_rows))
        assert np.array_equal(t.slot_of.numpy(), np.asarray(j.slot_of))
        assert np.array_equal(t.to_dense().numpy(), np.asarray(j.to_dense()))
    finally:
        t.close()
        j.close()


def test_out_of_range_ids_raise(dense):
    t = _cpu_table(dense, 4)
    with pytest.raises(ValueError, match="out of range"):
        t.pull(np.array([0, VOCAB]))
    with pytest.raises(ValueError, match="out of range"):
        t.push(np.array([-1]), np.zeros((1, DIM), np.float32), lr=0.1)
    t.close()


def test_dense_roundtrip_and_seeded_init(dense):
    t = _cpu_table(dense, 3, partition="block")
    assert np.array_equal(t.to_dense().numpy(), dense)
    assert [s.shape[0] for s in t.shards] == list(t.spec.shard_rows)
    t.close()
    a, b = (ShardedTable(VOCAB, DIM, 2, 7, init_scale=0.05, device="cpu")
            for _ in range(2))
    assert torch.equal(a.to_dense(), b.to_dense())
    assert 0.03 < float(a.to_dense().std()) < 0.07
    a.close()
    b.close()


# --------------------------------------------------------------------------
# dedup, hot cache, monitor
# --------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1])
def test_dedup_rows_equals_the_reference(seed):
    ids = _ids(seed=seed, vocab=12).reshape(-1)       # many duplicates
    g = _grads(ids.reshape(1, -1), seed=seed).reshape(-1, DIM)
    tu, ts = tpps.dedup_rows(torch.from_numpy(ids), torch.from_numpy(g),
                             fill_id=VOCAB)
    ju, js = jpps.dedup_rows(jnp.asarray(ids), jnp.asarray(g), fill_id=VOCAB)
    assert np.array_equal(tu.numpy(), np.asarray(ju))
    assert np.array_equal(ts.numpy(), np.asarray(js))
    small = tpps.dedup_rows(torch.tensor([5, 2, 5, 2, 5]),
                            torch.arange(5.0)[:, None].expand(5, 3), fill_id=10)
    assert small[0].tolist() == [2, 5, 10, 10, 10]
    assert small[1][:2].tolist() == [[4.0] * 3, [6.0] * 3]


def test_add_rows_adds_duplicates_in_stream_order():
    """Duplicates land as ((dst + s0) + s1) + …, the order np.add.at and
    the reference's scatter use — not a pre-summed s0 + s1."""
    dst = torch.tensor([[1.0], [0.0]])
    src = torch.tensor([[1e8], [-1e8], [1.0], [0.5]])
    got = tpps.add_rows(dst, torch.tensor([0, 0, 0, 1]), src)
    want = np.array([[1.0], [0.0]], np.float32)
    np.add.at(want, np.array([0, 0, 0, 1]), src.numpy())
    assert np.array_equal(got.numpy(), want)
    assert tpps.occurrence_rank(torch.tensor([3, 1, 3, 3, 1])).tolist() == \
        [0, 0, 1, 2, 1]


@pytest.mark.parametrize("dedup", [False, True])
def test_sparse_embedding_equals_the_reference(dense, dedup):
    ids, g = _ids(), _grads(_ids())
    t = tpps.SparseEmbedding(VOCAB, DIM, device="cpu")
    t.table = torch.from_numpy(dense)
    j = jpps.SparseEmbedding(VOCAB, DIM, jax.random.PRNGKey(1))
    j.table = jnp.asarray(dense)
    assert np.array_equal(t.lookup(torch.from_numpy(ids)).numpy(),
                          np.asarray(j.lookup(jnp.asarray(ids))))
    t.apply_sparse_grads(ids, g, lr=0.1, dedup=dedup)
    j.apply_sparse_grads(jnp.asarray(ids), jnp.asarray(g), lr=0.1,
                         dedup=dedup)
    assert np.array_equal(t.table.numpy(), np.asarray(j.table))


def test_hot_cache_write_through_keeps_cache_coherent(dense):
    """Interleaved re-pin/push/pull stays bit-exact vs the oracle, and
    skewed pulls land in the DEVICE tier once the cache is populated."""
    rng = np.random.default_rng(3)
    oracle = tpps.SparseEmbedding(VOCAB, DIM, device="cpu")
    oracle.table = torch.from_numpy(dense)
    monitor = AccessMonitor(VOCAB)
    t = _cpu_table(dense, 3, monitor=monitor, telemetry=PSTelemetry(3),
                   hot_capacity=16)
    placer = TierPlacer(t, monitor, interval=1)
    for round_ in range(4):
        ids = rng.integers(0, 40, (50,)).astype(np.int32)
        g = rng.standard_normal((50, DIM)).astype(np.float32)
        assert torch.equal(t.pull(ids),
                           tpps.sparse_pull(oracle.table,
                                            torch.from_numpy(ids))), round_
        t.push(ids, g, lr=0.1)
        oracle.apply_sparse_grads(ids, g, lr=0.1)
        placer.repin()
    assert torch.equal(t.to_dense(), oracle.table)
    assert placer.last_stats["cached_rows"] > 0
    assert t.telemetry.totals()["pull"]["hot_fraction"] > 0
    t.close()


def test_capacity_truncation_keeps_hottest(dense):
    monitor = AccessMonitor(VOCAB, TierThresholds(hot_fraction=0.95))
    t = _cpu_table(dense, 2, monitor=monitor, hot_capacity=2)
    monitor.record(np.array([7] * 50 + [3] * 30 + [9] * 10))
    stats = TierPlacer(t, monitor, interval=1).repin()
    assert stats["cached_rows"] == 2
    slot = t.slot_of.numpy()
    assert slot[7] >= 0 and slot[3] >= 0 and slot[9] < 0
    assert t.hot_rows.shape == (2, DIM)
    with pytest.raises(ValueError, match="monitor covers"):
        TierPlacer(t, AccessMonitor(VOCAB + 1))
    t.close()


def test_access_monitor_equals_the_reference():
    """Placement and EMA aging as the reference's, and its guards."""
    rng = np.random.default_rng(9)
    th = dict(hot_fraction=0.1, warm_fraction=0.5, ema=0.5)
    t, j = AccessMonitor(300, TierThresholds(**th)), JMonitor(
        300, JThresholds(**th))
    for _ in range(5):
        ids = (rng.pareto(1.2, 400) * 20).astype(np.int64) % 300
        t.record(ids)
        j.record(ids)
        assert np.array_equal(t.counts, j.counts)
        assert [x.value for x in t.placement()] == \
            [x.value for x in j.placement()]
        assert t.stats() == j.stats()
        t.age()
        j.age()
    assert Tier.DEVICE.value == "device"
    with pytest.raises(ValueError, match="row ids out of range"):
        t.record(np.array([0, 300]))
    assert AccessMonitor(0).placement().shape == (0,)


# --------------------------------------------------------------------------
# async client
# --------------------------------------------------------------------------


def _batches(n, seed=0):
    rng = np.random.default_rng(seed)
    return [{"ids": rng.integers(0, VOCAB, (13,)).astype(np.int32),
             "step": i} for i in range(n)]


def test_client_yields_in_order_and_drains_every_push(dense):
    t = _cpu_table(dense, 4)
    client = PSClient(t, iter(_batches(8)))
    seen = []
    for b, rows in client:                 # no pushes: rows are the table's
        seen.append(b["step"])
        assert np.array_equal(rows.numpy(), dense[b["ids"]])
    client.close()
    assert seen == list(range(8))
    client = PSClient(t, iter(_batches(10, seed=4)))
    counts = np.zeros(VOCAB)
    for b, _rows in client:
        np.add.at(counts, b["ids"], 1.0)
        client.push(b["ids"], np.ones((13, DIM), np.float32), lr=0.5)
    client.close()
    assert client.stats()["steps_pushed"] == 10
    np.testing.assert_allclose(t.to_dense().numpy() - dense,
                               -0.5 * counts[:, None] * np.ones((1, DIM)),
                               rtol=0, atol=1e-5)
    with pytest.raises(RuntimeError, match="close"):
        client.push(np.array([1]), np.zeros((1, DIM), np.float32), lr=0.1)
    t.close()


def test_client_surfaces_a_failed_push():
    class BrokenTable:
        def push(self, ids, grads, lr, dedup):
            raise ValueError("shard exploded")

    client = PSClient(BrokenTable(), iter([]), depth=8)
    client.push(np.array([1]), np.zeros((1, DIM), np.float32), lr=0.1)
    with pytest.raises(RuntimeError,
                       match=r"PS push failed: 1 push\(es\) dropped"):
        client.close(timeout=1.0)
    assert client.stats()["pushes_dropped"] == 1


# --------------------------------------------------------------------------
# telemetry and its cost-model bridge
# --------------------------------------------------------------------------


def test_telemetry_bytes_equal_the_reference(dense):
    ids = np.array([0, 1, 2, 3, 1, 57], np.int32)      # one duplicate
    g = np.ones((6, DIM), np.float32)
    reports = []
    for table in (_cpu_table(dense, 2, telemetry=PSTelemetry(2)),
                  JTable.from_dense(jnp.asarray(dense), 2,
                                    telemetry=JTelemetry(2))):
        table.pull(ids)
        table.push(ids, g, lr=0.1)
        tot = table.telemetry.totals()
        reports.append(({d: {k: tot[d][k] for k in ("ops", "rows", "bytes")}
                         for d in ("pull", "push")},
                        [{k: v for k, v in r.items() if not k.endswith("bw")}
                         for r in table.telemetry.shard_report()]))
        table.close()
    assert reports[0] == reports[1]
    assert reports[0][0]["push"]["bytes"] == 5 * (DIM * 4 + 4)


def test_cost_model_bridge_equals_the_reference():
    """The same recorded traffic gives the same measured resource and
    embedding ODT in both packages."""
    tels = (PSTelemetry(3), JTelemetry(3))
    for op, rows, secs, hot in (("pull", [5, 0, 7], 0.25, [1, 0, 2]),
                                ("push", [4, 3, 1], 0.5, None),
                                ("pull", [2, 2, 2], 0.125, [0, 0, 1])):
        for tel in tels:
            tel.record(op, rows=np.array(rows), bytes_=np.array(rows) * 68,
                       seconds=secs, hot_rows=None if hot is None
                       else np.array(hot))
    t, j = (tel.to_resource(base) for tel, base in zip(tels, (T_CPU, J_CPU)))
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.name == "cpu+ps" and t.price == T_CPU.price
    assert tels[0].embedding_odt(300) == tels[1].embedding_odt(300)
    assert tels[0].totals() == tels[1].totals()


# --------------------------------------------------------------------------
# transport and the spawned shard worker
# --------------------------------------------------------------------------


@pytest.fixture
def hard_timeout():
    """SIGALRM ceiling: a wedged shard process fails the test instead of
    wedging the runner."""
    def boom(signum, frame):
        raise TimeoutError("test exceeded its 120 s hard timeout")

    old = signal.signal(signal.SIGALRM, boom)
    signal.alarm(120)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)


def test_multiproc_matches_inproc(hard_timeout):
    """Real shard processes against the in-process backend, bit for bit,
    through pulls, pushes (with and without dedup) and a hot cache."""
    rng = np.random.default_rng(0)
    tables = [ShardedTable(VOCAB, DIM, 3, 7, partition="block",
                           transport=kind, device="cpu", hot_capacity=16)
              for kind in ("inproc", "multiproc")]
    try:
        for i in range(6):
            ids = rng.integers(0, VOCAB, size=int(rng.integers(3, 40)))
            grads = rng.normal(size=(ids.size, DIM)).astype(np.float32)
            pulled = [t.pull(ids) for t in tables]
            assert torch.equal(pulled[0], pulled[1])
            for t in tables:
                t.push(ids, grads, lr=0.01 * (i + 1), dedup=bool(i % 2))
                if i == 2:
                    t.install_hot_rows(np.arange(10))
        assert torch.equal(tables[0].to_dense(), tables[1].to_dense())
        assert torch.equal(tables[1].pull(np.arange(10)),
                           torch.from_numpy(tables[1]._fetch(np.arange(10))))
    finally:
        for t in tables:
            t.close()


def test_server_module_imports_without_torch():
    """The shard worker's import path stays numpy-only (the package inits
    are lazy), which keeps multiproc shard start-up at milliseconds."""
    code = ("import sys; import repro_torch.ps.server; "
            "import repro_torch.ps.transport; "
            "sys.exit(1 if 'torch' in sys.modules else 0)")
    proc = subprocess.run([sys.executable, "-c", code],
                          env={"PYTHONPATH": str(ROOT / "src"),
                               "PATH": "/usr/bin:/bin"},
                          capture_output=True, timeout=60)
    assert proc.returncode == 0, proc.stderr.decode()


# --------------------------------------------------------------------------
# the tower and the training loop
# --------------------------------------------------------------------------


def _reference_init(cfg):
    """The reference's initial table (make_table) and tower (init_tower),
    as numpy."""
    jt = jw.make_table(cfg, 3)
    table = np.asarray(jt.to_dense())
    jt.close()
    tower = jw.init_tower(cfg, jax.random.PRNGKey(cfg.seed + 1))
    return table, jax.tree.map(np.asarray, tower), tower


def test_tower_step_equals_make_step_fn():
    cfg = CTRConfig(**SMALL)
    jcfg = jw.CTRConfig(**SMALL)
    _, np_tower, jtower = _reference_init(jcfg)
    ttower = tower_from_numpy(np_tower, cfg, device="cpu")
    jstep, tstep = jw.make_step_fn(jcfg), make_step_fn(cfg)
    r = np.random.default_rng(0)
    for _ in range(3):
        emb = (r.standard_normal((64, 6, 8)) * 0.05).astype(np.float32)
        y = (r.random(64) > 0.5).astype(np.float32)
        jtower, jg, jloss = jstep(jtower, jnp.asarray(emb), jnp.asarray(y))
        ttower, tg, tloss = tstep(ttower, torch.from_numpy(emb),
                                  torch.from_numpy(y))
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
        np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-5,
                                   atol=1e-5 * float(np.abs(jg).max()))
        for k in ("w", "b"):
            for a, b in zip(ttower[k], jtower[k]):
                np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                           rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="tower shapes"):
        tower_from_numpy({"w": np_tower["w"][:1], "b": np_tower["b"][:1]},
                         cfg, device="cpu")


def _reference_sync_run(cfg, steps, num_shards, repin_interval):
    """train_ctr_ps's sync loop, step for step, on the reference's own
    pieces — returning what its summary does not: every loss, the final
    table and the hot cache."""
    table = jw.make_table(cfg, num_shards)
    placer = JPlacer(table, table.monitor, interval=repin_interval)
    step_fn = jw.make_step_fn(cfg)
    tower = jw.init_tower(cfg, jax.random.PRNGKey(cfg.seed + 1))
    stream, losses = jw.click_stream(cfg), []
    for i in range(steps):
        b = next(stream)
        rows = table.pull(b["ids"])
        tower, g, loss = step_fn(tower, rows, jnp.asarray(b["label"]))
        table.push(b["ids"], jax.block_until_ready(g),
                   lr=cfg.lr * cfg.emb_lr_scale)
        placer.step(i)
        losses.append(float(loss))
    out = {"losses": losses, "repins": placer.repins,
           "tier_stats": placer.last_stats,
           "dense": np.asarray(table.to_dense()),
           "slot_of": np.asarray(table.slot_of)}
    table.close()
    return out


def test_sync_training_follows_the_reference():
    jcfg, cfg = jw.CTRConfig(**SMALL), CTRConfig(**SMALL)
    ref = _reference_sync_run(jcfg, 25, 3, 10)
    summary = jw.train_ctr_ps(jcfg, steps=25, num_shards=3, mode="sync",
                              repin_interval=10)
    # the step-for-step loop above is the reference's train_ctr_ps
    assert (summary["first_loss"], summary["last_loss"]) == \
        (ref["losses"][0], ref["losses"][-1])
    assert summary["tier_stats"] == ref["tier_stats"]

    dense0, np_tower, _ = _reference_init(jcfg)
    table = make_table(cfg, 3, device="cpu", dense=dense0)
    try:
        s = train_ctr_ps(cfg, steps=25, num_shards=3, mode="sync",
                         repin_interval=10, table=table,
                         tower=tower_from_numpy(np_tower, cfg, device="cpu"))
        np.testing.assert_allclose(s["losses"], ref["losses"], rtol=0,
                                   atol=1e-4)
        assert s["repins"] == ref["repins"] == 2
        assert s["tier_stats"] == ref["tier_stats"]
        assert np.array_equal(table.slot_of.numpy(), ref["slot_of"])
        np.testing.assert_allclose(table.to_dense().numpy(), ref["dense"],
                                   rtol=0, atol=1e-5)
        assert s["hot_pulls"] == 14 and s["hot_pull_fraction"] > 0
        assert s["devices"] == {"tower": ["cpu"], "hot_cache": "cpu"}
        for key in summary:
            assert key in s
    finally:
        table.close()


def test_async_training_learns_and_drains_every_push():
    """Async mode, on a config small enough to learn within 40 steps (the
    reference's test config needs hundreds: a flat loss there says
    nothing): the loss decreases and every push reached every shard."""
    cfg = CTRConfig(vocab=100, emb_dim=8, slots=6, tower=(32,), batch=64,
                    lr=0.2)
    table = make_table(cfg, 3, device="cpu")
    try:
        s = train_ctr_ps(cfg, steps=40, num_shards=3, mode="async",
                         repin_interval=10, table=table)
        pushes = [table.transport.request(sh, {"op": "stats"})["counters"]
                  ["pushes"] for sh in range(3)]
    finally:
        table.close()
    assert s["steps"] == 40 and s["repins"] == 3
    assert s["loss_decreased"]
    assert np.mean(s["losses"][-5:]) < np.mean(s["losses"][:5]) - 0.005
    assert pushes == [40, 40, 40]


def test_bad_mode_rejected():
    with pytest.raises(ValueError, match="sync|async"):
        train_ctr_ps(CTRConfig(vocab=100), steps=1, mode="turbo",
                     device="cpu")


def test_train_sparse_ps_on_the_cpu_and_its_cli(capsys):
    s = ttrain.train_sparse_ps(steps=12, batch=32, num_shards=2, sync=True,
                               repin_interval=5, log_every=0, device="cpu")
    assert s["steps"] == 12 and s["repins"] == 2 and s["num_shards"] == 2
    assert s["devices"]["tower"] == ["cpu"]
    ttrain.main(["--sparse-ps", "--steps", "3", "--batch", "16",
                 "--ps-shards", "2", "--ps-sync", "--device", "cpu"])
    out = capsys.readouterr().out
    assert '"mode": "sync"' in out and '"steps": 3' in out


def test_sparse_ps_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttrain.train_sparse_ps(steps=1)


@pytest.mark.parametrize("kwargs,item", [
    ({"optimizer": "adagrad"}, "item 11"),
    ({"events": ["10:join"]}, "item 11"),
    ({"ckpt_dir": "ckpt", "ckpt_every": 5}, "item 11"),
    ({"fault_schedule": "crash,shard=0,after=4"}, "item 11"),
    ({"replan": True}, "item 9"),
])
def test_elastic_and_replan_options_raise(kwargs, item):
    with pytest.raises(NotImplementedError, match=item):
        ttrain.train_sparse_ps(steps=1, device="cpu", **kwargs)


@pytest.mark.parametrize("flags", [["--ps-optimizer", "adam"],
                                   ["--ps-event", "40:join"],
                                   ["--ckpt-dir", "c", "--ckpt-every", "2"],
                                   ["--ps-fault", "crash,shard=0"],
                                   ["--replan"]])
def test_elastic_and_replan_flags_raise(flags):
    with pytest.raises(NotImplementedError, match="ROADMAP.md queue 1"):
        ttrain.main(["--sparse-ps", "--steps", "1", "--device", "cpu",
                     *flags])


def test_click_stream_equals_the_reference():
    cfg, jcfg = CTRConfig(**SMALL), jw.CTRConfig(**SMALL)
    for a, b, _ in zip(tw.click_stream(cfg), jw.click_stream(jcfg), range(3)):
        assert np.array_equal(a["ids"], b["ids"])
        assert np.array_equal(a["label"], b["label"])
