"""Elastic PS fleet — shards join/leave/fail at runtime (HeterPS §3 +
the elastic parameter-service design space from PAPERS.md; port of
``repro.ps.elastic``).

:class:`ElasticPSFleet` hosts one logical ``(V, D)`` embedding table on a
*changing* set of shard processes behind any
:class:`~repro_torch.ps.transport.Transport`.  The unit of placement is the
**bucket** — a contiguous vocab slab (:class:`BucketSpec`) — and three
mechanisms make the fleet elastic without ever pausing training:

**Replication.**  Every bucket has a primary and (with ``replicas=1``) a
backup on a different shard.  A push is one fan-out: the primary gets the
``grad`` message, the backup gets the *same* message flagged ``replica``.
Because the PS-hosted optimizer (:func:`repro_torch.ps.server.apply_grads`) is
deterministic and per-shard FIFO keeps the update order, the backup's
slab + optimizer state stay **bit-identical** to the primary's — which is
what makes recovery lossless.

**Recovery.**  A lost shard (``kill()``, crash, or timeout — surfaced as
:class:`~repro_torch.ps.transport.PSShardLost`) triggers :meth:`recover`: every
bucket it primaried is promoted to its backup, every bucket it backed is
re-replicated from its primary (snapshot → install), and in-flight
migrations touching the shard are aborted to the surviving replica.  The
promoted slab is exactly the lost shard's last acked state (pinned by the
property tests in ``tests/test_torch_elastic.py``).

**Live migration.**  Moving bucket *B* from shard *src* to *dst* never
blocks pulls or pushes:

1. *begin* (atomic w.r.t. pushes): snapshot *B* at src — slab, optimizer
   state, acked counter — and install it at dst; mark *B* migrating.
2. while migrating, pushes touching *B* are appended to a drain buffer
   for dst.  The first ``staleness_bound`` of them skip src (cheap,
   single-apply); beyond the bound every push is **dual-written** to src
   too, so a pull against the migrating range — still served by src — is
   never stale by more than ``staleness_bound`` updates.  The backup
   keeps receiving every push throughout, so replication never weakens.
3. *finish*: drain the buffer to dst in push order, flip the primary map,
   drop *B* at src.  If dst already held *B*'s replica, the whole dance
   collapses to a map flip (the replica is bit-identical by invariant).

``join()`` = spawn a shard + migrate it a fair share of buckets;
``leave()`` = migrate everything away, then a graceful stop;
``kill()`` = fault injection (terminate, no flush).

The fleet exposes the same ``pull/push(ids, grads, lr=..., dedup=...)``
surface as :class:`~repro_torch.ps.sharding.ShardedTable`, so
:class:`~repro_torch.ps.client.PSClient` overlaps it with compute
unchanged.  As there, ``pull`` returns float32 rows on the fleet's
``device`` (default ``cuda``), and ``push`` dedups the gradient where it
lies (on the card in a card run) with ``parallel.ps.dedup_rows``, which
adds duplicates in stream order — for the same input, bit for bit the
reference's sum — then reads the summed rows back to the host for the
shards.  The shards and their slabs stay in host memory.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.obs import trace as obs_trace
from repro_torch.parallel.ps import dedup_rows
from repro_torch.ps.server import OPTIMIZERS
from repro_torch.ps.sharding import _host_ids, _sync
from repro_torch.ps.transport import PSShardLost, Transport, make_transport


class PSUnrecoverable(RuntimeError):
    """Replica promotion cannot save this fleet: some bucket lost its
    primary *and* every replica (correlated failure — e.g. a preempted
    zone taking both copies).  The only way back is a durable
    checkpoint: :meth:`ElasticPSFleet.restore_snapshot` +
    :mod:`repro_torch.ps.snapshot`'s :class:`~repro_torch.ps.snapshot.
    FleetCheckpointer`."""


class BucketSpec:
    """Contiguous vocab slabs — the unit of placement, migration and
    replication.  More buckets than shards (default 4×) keeps rebalance
    granular: a joining shard can take a fair share without splitting."""

    def __init__(self, vocab: int, dim: int, num_buckets: int):
        if not 1 <= num_buckets <= vocab:
            raise ValueError(
                f"num_buckets={num_buckets} outside [1, vocab={vocab}]")
        self.vocab = vocab
        self.dim = dim
        self.num_buckets = num_buckets
        self.bucket_rows = -(-vocab // num_buckets)  # ceil

    def bucket_of(self, ids):
        return np.clip(ids // self.bucket_rows, 0, self.num_buckets - 1)

    def local(self, ids):
        return ids - self.bucket_of(ids) * self.bucket_rows

    def rows_in(self, bucket: int) -> int:
        lo = bucket * self.bucket_rows
        return max(0, min(self.bucket_rows, self.vocab - lo))

    def global_rows(self, bucket: int) -> np.ndarray:
        lo = bucket * self.bucket_rows
        return np.arange(lo, lo + self.rows_in(bucket))


def _dedup_sum(ids: np.ndarray, grads, *, vocab: int, dim: int):
    """Client half of an elastic push: one summed f32 gradient row per
    distinct id (padding slots carry ``vocab``) — the one-update-per-row
    guarantee the PS-hosted adaptive optimizers rely on.  Runs on the
    device that holds ``grads`` and returns host arrays ``(ids, rows)``
    of the live (non-padding) entries."""
    g = torch.as_tensor(grads).detach()
    pids, summed = dedup_rows(
        torch.as_tensor(ids.reshape(-1), device=g.device),
        g.reshape(-1, dim).to(torch.float32), fill_id=vocab)
    pids_np = pids.cpu().numpy()
    live = pids_np < vocab
    return pids_np[live].astype(np.int64), summed.cpu().numpy()[live]


class ElasticPSFleet:
    """One logical embedding table on an elastic shard fleet.

    Parameters:
      optimizer: PS-hosted update rule applied **on the shard** from raw
        summed gradients — ``"sgd"`` | ``"adagrad"`` | ``"adam"``
        (``hyper`` carries betas/eps).
      replicas: 0 (no fault tolerance) or 1 (synchronous backup per
        bucket; requires ≥2 shards to actually place one).
      staleness_bound: max number of in-migration pushes a pull against
        the migrating range may miss; 0 → full dual-write (never stale).
      transport: ``None``/``"inproc"`` | ``"multiproc"`` | instance.
      telemetry: optional :class:`~repro_torch.ps.telemetry.PSTelemetry`;
        grown on join, also records join/leave/kill/migration/recovery
        events.
      seed: ``None`` (→ zeros) or the seed of a ``torch.Generator`` that
        draws the initial table ``N(0, 1) * init_scale`` (default scale
        ``dim**-0.5``) on the CPU, as :class:`~repro_torch.ps.sharding.
        ShardedTable` draws its own.
      dense: the initial ``(V, D)`` table as a float32 host array, in
        place of ``seed`` (what :meth:`from_dense` passes).  Either way
        the shards receive one ``create`` per bucket copy, as in the
        reference, so a fault schedule counts the same attempts.
      device: where pulled rows land (default ``cuda``); the shard slabs
        stay in host memory.
    """

    def __init__(self, vocab: int, dim: int, *, num_shards: int = 2,
                 num_buckets: int | None = None, optimizer: str = "sgd",
                 hyper: dict | None = None, replicas: int = 1,
                 staleness_bound: int = 8,
                 transport: str | Transport | None = None,
                 telemetry=None, seed: int | None = None,
                 init_scale: float | None = None,
                 rpc_latency_s: float = 0.0, device=None,
                 dense: np.ndarray | None = None):
        self.device = resolve_device(device)
        if num_shards < 1:
            raise ValueError("num_shards must be >= 1")
        if optimizer not in OPTIMIZERS or optimizer == "none":
            raise ValueError(
                f"fleet optimizer must be one of {OPTIMIZERS[1:]}, "
                f"got {optimizer!r}")
        if replicas not in (0, 1):
            raise ValueError("replicas must be 0 or 1")
        if dense is not None:
            if dense.shape != (vocab, dim):
                raise ValueError(f"dense table of shape {dense.shape}, the "
                                 f"fleet holds {(vocab, dim)}")
        elif seed is not None:
            scale = dim**-0.5 if init_scale is None else init_scale
            g = torch.Generator().manual_seed(seed)
            dense = (torch.randn((vocab, dim), generator=g) * scale).numpy()
        else:
            dense = np.zeros((vocab, dim), np.float32)
        self.spec = BucketSpec(
            vocab, dim, num_buckets or max(1, min(vocab, 4 * num_shards)))
        self.optimizer = optimizer
        self.hyper = dict(hyper or {})
        self.replicas = replicas
        self.staleness_bound = int(staleness_bound)
        self.telemetry = telemetry
        self.rpc_latency_s = float(rpc_latency_s)
        self.transport = make_transport(transport)
        # proactive failure detection: the multiproc heartbeat reports a
        # dead worker here within its deadline, instead of waiting for
        # the next pull/push to trip over it
        self.transport.on_shard_lost = self._on_lost
        self._mu = threading.RLock()
        self._next_sid = 0
        self.events: list[dict] = []
        #: bucket → shard maps (−1 = no backup placed)
        nb = self.spec.num_buckets
        self.primary = np.empty((nb,), np.int64)
        self.backup = np.full((nb,), -1, np.int64)
        #: bucket → in-flight migration state
        self._migrations: dict[int, dict] = {}

        for _ in range(num_shards):
            self._spawn()
        for b in range(nb):
            self.primary[b] = b % num_shards
            if replicas and num_shards > 1:
                self.backup[b] = (b + 1) % num_shards

        self._load_dense(dense)

    # --- construction ----------------------------------------------------
    def _spawn(self) -> int:
        sid = self._next_sid
        self._next_sid += 1
        self.transport.add_shard(sid, dim=self.spec.dim,
                                 optimizer=self.optimizer, hyper=self.hyper)
        if self.telemetry is not None:
            self.telemetry.ensure(self._next_sid)
        return sid

    def _load_dense(self, dense: np.ndarray) -> None:
        msgs = []
        for b in range(self.spec.num_buckets):
            rows = dense[self.spec.global_rows(b)]
            msgs.append((int(self.primary[b]),
                         {"op": "create", "bucket": b, "rows": rows}))
            if self.backup[b] >= 0:
                msgs.append((int(self.backup[b]),
                             {"op": "create", "bucket": b, "rows": rows}))
        self.transport.request_many(msgs)

    @classmethod
    def from_dense(cls, table, **kw) -> "ElasticPSFleet":
        """A fleet holding ``table`` (a ``(V, D)`` array or tensor, e.g.
        the reference's dense table as numpy)."""
        t = (table.detach().to("cpu", torch.float32).numpy()
             if isinstance(table, torch.Tensor)
             else np.asarray(table, np.float32))
        return cls(t.shape[0], t.shape[1], dense=t, **kw)

    # --- helpers ---------------------------------------------------------
    def _event(self, kind: str, **fields) -> None:
        ev = {"kind": kind, **fields}
        self.events.append(ev)
        if self.telemetry is not None:
            self.telemetry.record_event(ev)
        # lifecycle markers on the trace timeline (join/leave/kill/
        # migrate/recover show up as instants in the fleet's lane)
        obs_trace.instant("ps.fleet." + kind, "ps", **fields)

    def _check_ids(self, ids_np: np.ndarray) -> None:
        if ids_np.size and (ids_np.min() < 0
                            or ids_np.max() >= self.spec.vocab):
            raise ValueError(
                f"ids out of range for vocab={self.spec.vocab}: "
                f"[{ids_np.min()}, {ids_np.max()}]")

    def _group(self, owner: np.ndarray, bucket: np.ndarray,
               local: np.ndarray, payload: np.ndarray | None, op: str,
               **extra) -> list[tuple[int, dict]]:
        """One message per distinct owner shard (ids grouped stably)."""
        order = np.argsort(owner, kind="stable")
        bounds = np.flatnonzero(np.diff(owner[order])) + 1
        msgs = []
        for seg in np.split(order, bounds):
            msg = {"op": op, "buckets": bucket[seg], "ids": local[seg],
                   **extra}
            if payload is not None:
                msg["grads" if op == "grad" else "updates"] = payload[seg]
            msgs.append((int(owner[seg[0]]), msg))
        return msgs

    def _primary_load(self) -> dict[int, int]:
        live = self.transport.live_shards
        load = {s: 0 for s in live}
        for b in range(self.spec.num_buckets):
            if self.primary[b] in load:
                load[int(self.primary[b])] += 1
        return load

    def _pick_backup(self, bucket: int, exclude: set[int] = frozenset()
                     ) -> int:
        """Least-loaded live shard ≠ primary (−1 if none exists)."""
        p = int(self.primary[bucket])
        cand = [s for s in self.transport.live_shards
                if s != p and s not in exclude]
        if not cand or not self.replicas:
            return -1
        load = self._primary_load()
        return min(cand, key=lambda s: (load.get(s, 0), s))

    def _replicate(self, bucket: int, dst: int) -> None:
        """snapshot(primary) → install(dst): dst becomes the bit-exact
        replica of the bucket's current state."""
        snap = self.transport.request(
            int(self.primary[bucket]), {"op": "snapshot", "bucket": bucket})
        self.transport.request(dst, {
            "op": "install", "bucket": bucket, "rows": snap["rows"],
            "opt": snap["opt"], "acked": snap["acked"]})

    # --- PS operations ---------------------------------------------------
    def pull(self, ids):
        """Pull the touched rows: ``ids (...,)`` (host array or tensor) →
        ``(..., D)`` float32 on the fleet's device.  A shard lost
        mid-pull triggers recovery and a transparent retry."""
        t0 = time.perf_counter()
        ids_np = _host_ids(ids)
        self._check_ids(ids_np)
        flat = ids_np.ravel().astype(np.int64)
        bucket = np.asarray(self.spec.bucket_of(flat))
        local = flat - bucket * self.spec.bucket_rows
        out = np.empty((flat.size, self.spec.dim), np.float32)
        while True:
            with self._mu:
                owner = self.primary[bucket]
            order = np.argsort(owner, kind="stable")
            bounds = np.flatnonzero(np.diff(owner[order])) + 1
            segs = np.split(order, bounds) if flat.size else []
            msgs = [(int(owner[seg[0]]),
                     {"op": "pull", "buckets": bucket[seg],
                      "ids": local[seg]}) for seg in segs]
            try:
                replies = self.transport.request_many(msgs)
            except PSShardLost as e:
                self.recover(getattr(e, "shard_ids", None))
                continue
            for seg, rep in zip(segs, replies):
                out[seg] = rep["rows"]
            break
        rows = torch.from_numpy(
            out.reshape(ids_np.shape + (self.spec.dim,))).to(self.device)
        _sync(self.device)
        if self.rpc_latency_s:
            time.sleep(self.rpc_latency_s)
        self._account("pull", bucket, owner, time.perf_counter() - t0,
                      self.spec.dim * 4)
        return rows

    def push(self, ids, row_grads, *, lr: float, dedup: bool = True):
        """Push raw row gradients; the shard-side optimizer applies them.

        Fan-out per bucket: primary ``grad`` + backup ``grad(replica)``;
        migrating buckets buffer for the destination instead (dual-
        writing to the source past ``staleness_bound``).  A shard lost
        mid-push needs **no resend**: its buckets' surviving replicas
        received the same update, and recovery promotes them.
        """
        t0 = time.perf_counter()
        ids_np = _host_ids(ids)
        self._check_ids(ids_np)
        if dedup:
            flat, grads = _dedup_sum(ids_np, row_grads,
                                     vocab=self.spec.vocab,
                                     dim=self.spec.dim)
        else:
            flat = ids_np.ravel().astype(np.int64)
            grads = torch.as_tensor(row_grads).detach().to(
                "cpu", torch.float32).numpy().reshape(-1, self.spec.dim)
        bucket = np.asarray(self.spec.bucket_of(flat))
        local = flat - bucket * self.spec.bucket_rows
        with self._mu:
            migrating = np.array(
                [b in self._migrations for b in bucket], bool) \
                if self._migrations else np.zeros(bucket.shape, bool)
            msgs: list[tuple[int, dict]] = []
            steady = ~migrating
            if steady.any():
                ow = self.primary[bucket[steady]]
                msgs += self._group(ow, bucket[steady], local[steady],
                                    grads[steady], "grad", lr=float(lr))
                bk = self.backup[bucket[steady]]
                has_bk = bk >= 0
                if has_bk.any():
                    msgs += self._group(
                        bk[has_bk], bucket[steady][has_bk],
                        local[steady][has_bk], grads[steady][has_bk],
                        "grad", lr=float(lr), replica=True)
            if migrating.any():
                for b in np.unique(bucket[migrating]):
                    sel = migrating & (bucket == b)
                    item = (local[sel], grads[sel], float(lr))
                    mig = self._migrations[int(b)]
                    mig["buffer"].append(item)
                    dual = mig["buffer_only"] >= self.staleness_bound
                    if dual:
                        msgs.append((int(self.primary[b]), {
                            "op": "grad", "buckets": bucket[sel],
                            "ids": item[0], "grads": item[1],
                            "lr": float(lr)}))
                    else:
                        mig["buffer_only"] += 1
                    if self.backup[b] >= 0:
                        msgs.append((int(self.backup[b]), {
                            "op": "grad", "buckets": bucket[sel],
                            "ids": item[0], "grads": item[1],
                            "lr": float(lr), "replica": True}))
            try:
                self.transport.request_many(msgs)
            except PSShardLost as e:
                self.recover(getattr(e, "shard_ids", None))
            owner = self.primary[bucket]
        if self.rpc_latency_s:
            time.sleep(self.rpc_latency_s)
        self._account("push", bucket, owner, time.perf_counter() - t0,
                      self.spec.dim * 4 + 8)
        return self

    def _account(self, op: str, bucket: np.ndarray, owner: np.ndarray,
                 seconds: float, bytes_per_row: int) -> None:
        if self.telemetry is None or owner.size == 0:
            return
        self.telemetry.ensure(self._next_sid)
        per_shard = np.bincount(owner, minlength=self._next_sid)
        self.telemetry.record(op, rows=per_shard,
                              bytes_=per_shard * bytes_per_row,
                              seconds=seconds)

    # --- elasticity ------------------------------------------------------
    def join(self, *, rebalance: bool = True) -> int:
        """Bring a new shard process up and (by default) migrate it a
        fair share of buckets.  Training continues throughout."""
        t0 = time.perf_counter()
        with self._mu:
            sid = self._spawn()
            moved = []
            if rebalance:
                live = self.transport.live_shards
                target = self.spec.num_buckets // max(1, len(live))
                load = self._primary_load()
                donors = sorted((b for b in range(self.spec.num_buckets)
                                 if b not in self._migrations),
                                key=lambda b: -load.get(
                                    int(self.primary[b]), 0))
                for b in donors:
                    if len(moved) >= target:
                        break
                    if self.primary[b] == sid or self.backup[b] == sid:
                        continue
                    self.migrate(b, sid)
                    moved.append(b)
        self._event("join", shard=sid, buckets=moved,
                    seconds=time.perf_counter() - t0)
        return sid

    def leave(self, shard_id: int) -> None:
        """Graceful decommission: migrate every bucket away, re-home the
        replicas it held, then stop the process."""
        t0 = time.perf_counter()
        with self._mu:
            live = sorted(self.transport.live_shards - {shard_id})
            if not live:
                raise RuntimeError("cannot decommission the last shard")
            load = self._primary_load()
            load.pop(shard_id, None)
            for b in np.flatnonzero(self.primary == shard_id):
                dst = min(load, key=lambda s: (load[s], s))
                self.migrate(int(b), dst)
                load[dst] += 1
            for b in np.flatnonzero(self.backup == shard_id):
                b = int(b)
                nb = self._pick_backup(b, exclude={shard_id})
                self.backup[b] = nb
                if nb >= 0:
                    self._replicate(b, nb)
            self.transport.stop_shard(shard_id)
        self._event("leave", shard=shard_id,
                    seconds=time.perf_counter() - t0)

    def kill(self, shard_id: int) -> None:
        """Fault injection: terminate the shard with no flush.  State is
        recovered from replicas on the next touch (or ``recover()``)."""
        self.transport.kill_shard(shard_id)
        self._event("kill", shard=shard_id)

    def _on_lost(self, shard_id: int) -> None:
        """Heartbeat callback (failure-detector thread): recover
        proactively so the next pull/push already sees a healthy map.
        An unrecoverable fleet is left for the training thread to trip
        over — raising out of the detector would only kill it."""
        self._event("detected", shard=int(shard_id))
        try:
            self.recover({int(shard_id)})
        except PSUnrecoverable:
            pass
        except PSShardLost:
            pass  # another shard died mid-recovery — next touch retries

    def recover(self, lost: set[int] | None = None) -> list[int]:
        """Re-home every bucket whose primary/backup died: promote the
        backup (bit-exact last-acked state), then re-replicate.  Returns
        the shards recovered from."""
        t0 = time.perf_counter()
        with self._mu:
            live = self.transport.live_shards
            dead = {int(s) for s in set(self.primary) | set(self.backup)
                    if s >= 0 and s not in live}
            if lost:
                dead |= {s for s in lost if s not in live}
            if not dead:
                return []
            # abort migrations involving a dead shard first — the
            # surviving replica carries every push (incl. buffered ones)
            for b, mig in list(self._migrations.items()):
                src, dst = int(self.primary[b]), mig["dst"]
                if src not in dead and dst not in dead:
                    continue
                if dst not in dead:
                    self.transport.request(dst, {"op": "drop", "bucket": b})
                elif src not in dead and mig["buffer_only"] > 0:
                    # dst died holding buffer-only pushes src never saw —
                    # the backup saw every one of them, so it becomes the
                    # primary and the stale src is rebuilt as its replica
                    k = int(self.backup[b])
                    if k < 0 or k in dead:
                        raise PSUnrecoverable(
                            f"bucket {b} lost migration dst {dst} with "
                            f"{mig['buffer_only']} unreplicated pushes and "
                            f"no live backup — unrecoverable")
                    self.primary[b], self.backup[b] = k, src
                    self._replicate(b, src)
                del self._migrations[b]
            for b in range(self.spec.num_buckets):
                p, k = int(self.primary[b]), int(self.backup[b])
                if p in dead and k in dead:
                    raise PSUnrecoverable(
                        f"bucket {b} lost both primary {p} and backup {k} "
                        f"— unrecoverable (replicas={self.replicas})")
                if p in dead:
                    if k < 0:
                        raise PSUnrecoverable(
                            f"bucket {b} lost primary {p} with no backup "
                            f"— unrecoverable (replicas={self.replicas})")
                    self.primary[b], k = k, p  # promote
                    self.backup[b] = -1
                if int(self.backup[b]) in dead:
                    self.backup[b] = -1
                if self.backup[b] < 0 and self.replicas:
                    nb = self._pick_backup(b)
                    if nb >= 0:
                        self._replicate(b, nb)
                        self.backup[b] = nb
        recovered = sorted(dead)
        self._event("recover", shards=recovered,
                    seconds=time.perf_counter() - t0)
        return recovered

    def restore_snapshot(self, snap: dict) -> None:
        """Reload the whole fleet from a :func:`repro_torch.ps.snapshot.
        snapshot_fleet` capture — the recovery path when replica
        promotion is out of moves (:class:`PSUnrecoverable`).

        Every surviving shard is wiped of its (stale) buckets, fresh
        shards are spawned until enough exist to host primaries (+ a
        backup when ``replicas=1``), ownership is reassigned round-robin
        over the live set, and each bucket's slab + optimizer state +
        acked counter is installed bit-exactly as captured.  In-flight
        migrations are discarded (their state predates the snapshot's
        watermark).
        """
        meta = snap.get("meta", {})
        for k, want in (("vocab", self.spec.vocab), ("dim", self.spec.dim),
                        ("num_buckets", self.spec.num_buckets),
                        ("optimizer", self.optimizer)):
            if k in meta and meta[k] != want:
                raise ValueError(
                    f"snapshot {k}={meta[k]!r} != fleet {k}={want!r}")
        nb = self.spec.num_buckets
        buckets = {int(b): st for b, st in snap["buckets"].items()}
        missing = [b for b in range(nb) if b not in buckets]
        if missing:
            raise ValueError(f"snapshot missing buckets {missing}")
        t0 = time.perf_counter()
        with self._mu:
            self._migrations.clear()
            need = 2 if self.replicas else 1
            while len(self.transport.live_shards) < need:
                self._spawn()
            live = sorted(self.transport.live_shards)
            # survivors may host buckets whose state post- or pre-dates
            # the snapshot in unknown ways — wipe before reinstall
            self.transport.request_many(
                [(s, {"op": "drop", "bucket": b})
                 for s in live for b in range(nb)])
            msgs = []
            for b in range(nb):
                p = live[b % len(live)]
                k = (live[(b + 1) % len(live)]
                     if self.replicas and len(live) > 1 else -1)
                self.primary[b], self.backup[b] = p, k
                st = buckets[b]
                body = {"op": "install", "bucket": b, "rows": st["rows"],
                        "opt": st["opt"], "acked": int(st["acked"])}
                msgs.append((p, body))
                if k >= 0:
                    msgs.append((k, body))
            self.transport.request_many(msgs)
        self._event("restore", shards=live, buckets=nb,
                    step=meta.get("step"),
                    seconds=time.perf_counter() - t0)

    # --- live migration --------------------------------------------------
    def migrate(self, bucket: int, dst: int) -> None:
        """Move ``bucket`` to shard ``dst`` (begin + immediate finish —
        the no-traffic case; concurrent trainers use the staged form
        implicitly via ``join``/``leave`` under load)."""
        self.begin_migration(bucket, dst)
        self.finish_migration(bucket)

    def begin_migration(self, bucket: int, dst: int) -> None:
        """Stage 1: snapshot at src, install at dst, start buffering.
        If dst holds the bucket's replica this is a pure map flip."""
        with self._mu:
            bucket = int(bucket)
            src = int(self.primary[bucket])
            if dst == src:
                return
            if bucket in self._migrations:
                raise RuntimeError(f"bucket {bucket} is already migrating")
            if dst not in self.transport.live_shards:
                raise PSShardLost(f"migration destination {dst} not live")
            if dst == int(self.backup[bucket]):
                # the replica is bit-identical by invariant — flip roles
                self.primary[bucket], self.backup[bucket] = dst, src
                self._event("migrate", bucket=bucket, src=src, dst=dst,
                            promoted_replica=True, seconds=0.0)
                return
            self._replicate(bucket, dst)
            self._migrations[bucket] = {
                "dst": dst, "buffer": [], "buffer_only": 0,
                "t0": time.perf_counter()}

    def migration_backlog(self, bucket: int) -> int:
        """Pushes buffered for the destination (staged-API observability;
        ``buffer_only`` of them are invisible at the source — bounded by
        ``staleness_bound``)."""
        with self._mu:
            mig = self._migrations.get(int(bucket))
            return len(mig["buffer"]) if mig else 0

    def migration_staleness(self, bucket: int) -> int:
        """How many updates a pull of the migrating range may currently
        miss (≤ ``staleness_bound`` by construction)."""
        with self._mu:
            mig = self._migrations.get(int(bucket))
            return mig["buffer_only"] if mig else 0

    def finish_migration(self, bucket: int) -> None:
        """Stage 2: drain the buffer to dst in push order, flip the
        primary map, drop the bucket at src."""
        with self._mu:
            bucket = int(bucket)
            mig = self._migrations.get(bucket)
            if mig is None:
                return
            src, dst = int(self.primary[bucket]), mig["dst"]
            for local, grads, lr in mig["buffer"]:
                self.transport.request(dst, {
                    "op": "grad",
                    "buckets": np.full(local.shape, bucket, np.int64),
                    "ids": local, "grads": grads, "lr": lr})
            self.primary[bucket] = dst
            del self._migrations[bucket]
            try:
                self.transport.request(src, {"op": "drop", "bucket": bucket})
            except PSShardLost:
                pass  # src died after we copied everything out — fine
            self._event("migrate", bucket=bucket, src=src, dst=dst,
                        drained=len(mig["buffer"]),
                        seconds=time.perf_counter() - mig["t0"])

    # --- inspection ------------------------------------------------------
    def to_dense(self):
        """Reassemble the logical ``(V, D)`` table from the bucket
        primaries, on the host."""
        dense = np.empty((self.spec.vocab, self.spec.dim), np.float32)
        with self._mu:
            msgs = [(int(self.primary[b]), {"op": "snapshot", "bucket": b})
                    for b in range(self.spec.num_buckets)]
            replies = self.transport.request_many(msgs)
        for b, rep in enumerate(replies):
            dense[self.spec.global_rows(b)] = rep["rows"]
        return torch.from_numpy(dense)

    def owners(self) -> tuple[np.ndarray, np.ndarray]:
        """Copies of the (primary, backup) bucket→shard maps."""
        with self._mu:
            return self.primary.copy(), self.backup.copy()

    def stats(self) -> dict:
        with self._mu:
            live = sorted(self.transport.live_shards)
            shard_stats = {
                s: rep for s, rep in zip(live, self.transport.request_many(
                    [(s, {"op": "stats"}) for s in live]))}
            return {"live_shards": live,
                    "primary": self.primary.tolist(),
                    "backup": self.backup.tolist(),
                    "migrating": sorted(self._migrations),
                    "shards": shard_stats,
                    "events": list(self.events)}

    @property
    def vocab(self) -> int:
        return self.spec.vocab

    @property
    def dim(self) -> int:
        return self.spec.dim

    @property
    def num_shards(self) -> int:
        return len(self.transport.live_shards)

    def close(self) -> None:
        self.transport.close()
        if self.telemetry is not None:
            self.telemetry.close()
