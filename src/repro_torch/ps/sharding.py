"""Sharded parameter-server table — HeterPS §3's CPU-PS tier, scaled out
(port of ``repro.ps.sharding``).

The paper keeps huge sparse embedding tables on CPU parameter servers and
shards them across hosts; workers pull only the touched rows and push
sparse row gradients back.  :class:`ShardedTable` vocab-partitions one
logical ``(V, D)`` table across ``N`` PS shards and **speaks the message
protocol** of :mod:`repro_torch.ps.server` to them through a pluggable
:class:`~repro_torch.ps.transport.Transport`:

* each shard is an endpoint owning one slab bucket in host memory — a
  :class:`~repro_torch.ps.server.ShardServer` behind an in-process queue
  (default: deterministic, the tests' oracle path) or a real worker
  process (:class:`~repro_torch.ps.transport.MultiprocTransport`);
* ``pull`` routes ids to their owners, fans the per-shard requests out
  in one ``request_many`` round, reassembles the rows in id order and
  moves them to the table's device; ``push`` brings the row gradients to
  the host, dedups duplicate ids via ``dedup_rows`` and pre-scales the
  update there (``-lr * summed_grads``), so the shard's f32 ``+=`` lands
  bit-identically to the single-array scatter-add of :func:`sharded_update`
  (pinned in ``tests/test_torch_ps.py``).  The dedup runs on the host
  because the rows go there anyway, and its segment sum adds duplicates
  in stream order on every device (``parallel.ps.add_rows``);
* tier-aware placement stays **client-side**: a fixed-capacity
  **hot-row cache** (``hot_rows`` + an id→slot map) on the table's
  device holds the rows the access monitor marked DEVICE-tier.  Pulls
  merge hot rows over the transport's cold rows, gathering them with the
  embedding-bag kernel (``kernels.ops.embedding_bag`` with bag 1, exact);
  pushes write through to both, so the two stay bit-identical;
* every pull/push is metered per shard (bytes, rows, wall time) by an
  attached :class:`~repro_torch.ps.telemetry.PSTelemetry`.

The fused single-array functions (:func:`sharded_pull`,
:func:`sharded_update` over one shard-major storage array) are the
reference the message path is pinned against; their gathers go through
the embedding-bag kernel too.

Streams: a pull or push ends by synchronizing the *current* stream of
its thread only, so :class:`~repro_torch.ps.client.PSClient`'s puller and
pusher, each on its own stream, never wait for the tower running on the
main thread's stream.  A new cache or slot map is complete on the device
before it is published.
"""

from __future__ import annotations

import dataclasses
import threading
import time

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.parallel.ps import add_rows, dedup_rows
from repro_torch.ps.transport import Transport, make_transport

#: tier codes stored in the per-shard placement arrays (int8); index-aligned
#: with ``repro_torch.data.cache.Tier`` ordering DEVICE < HOST < DISK.
TIER_DEVICE, TIER_HOST, TIER_DISK = 0, 1, 2


@dataclasses.dataclass(frozen=True)
class RoutingSpec:
    """Static routing metadata.

    ``partition="mod"`` (default) assigns row ``i`` to shard ``i % N`` —
    balanced under the zipf-skewed id streams of CTR logs.  ``"block"``
    assigns contiguous vocab ranges (shard ``s`` owns
    ``[s*block, (s+1)*block)``) — the layout a range-partitioned
    key-value PS would use.
    """

    vocab: int
    dim: int
    num_shards: int
    partition: str = "mod"

    def __post_init__(self):
        if self.partition not in ("mod", "block"):
            raise ValueError(f"unknown partition {self.partition!r}")
        if not 1 <= self.num_shards <= max(1, self.vocab):
            raise ValueError(
                f"num_shards={self.num_shards} outside [1, vocab={self.vocab}]")

    @property
    def block(self) -> int:
        return -(-self.vocab // self.num_shards)  # ceil

    @property
    def shard_rows(self) -> tuple[int, ...]:
        if self.partition == "mod":
            return tuple(
                (self.vocab - s + self.num_shards - 1) // self.num_shards
                for s in range(self.num_shards))
        return tuple(
            max(0, min(self.block, self.vocab - s * self.block))
            for s in range(self.num_shards))

    @property
    def offsets(self) -> tuple[int, ...]:
        """Slab start of each shard in the shard-major storage layout."""
        out, acc = [], 0
        for r in self.shard_rows:
            out.append(acc)
            acc += r
        return tuple(out)

    def route(self, ids):
        """ids → (owner shard, local row).  Works on tensors and np arrays."""
        if self.partition == "mod":
            return ids % self.num_shards, ids // self.num_shards
        clip = torch.clamp if isinstance(ids, torch.Tensor) else np.clip
        return clip(ids // self.block, 0, self.num_shards - 1), \
            ids % self.block

    def flatten(self, ids):
        """ids → slot in the shard-major ``(V, D)`` storage array."""
        owner, local = self.route(ids)
        if isinstance(ids, torch.Tensor):
            return torch.as_tensor(self.offsets, dtype=ids.dtype,
                                   device=ids.device)[owner.long()] + local
        return np.asarray(self.offsets, dtype=np.asarray(ids).dtype)[
            owner] + local

    def global_rows(self, shard: int) -> np.ndarray:
        """Global row ids owned by ``shard``, in local-row (slab) order."""
        if self.partition == "mod":
            return np.arange(shard, self.vocab, self.num_shards)
        lo = shard * self.block
        return np.arange(lo, lo + self.shard_rows[shard])


# --------------------------------------------------------------------------
# single-array functions (the oracle the message path is pinned against)
# and the device halves of the message path
# --------------------------------------------------------------------------


def _gather_rows(table, idx, *, impl: str = "auto"):
    """``table[idx]`` for an index tensor of any shape → ``idx.shape +
    (D,)``, through the embedding-bag kernel with bag 1 (``0 + row``:
    exact).  ``impl`` as :func:`repro_torch.kernels.ops.embedding_bag`."""
    if idx.numel() == 0:
        return table.new_empty((*idx.shape, table.shape[1]))
    rows = ops.embedding_bag(idx.reshape(-1, 1), table, impl=impl)
    return rows.reshape(*idx.shape, table.shape[1])


def sharded_pull(data, hot_rows, slot_of, ids, *, spec: RoutingSpec,
                 impl: str = "auto"):
    """Routed pull over one shard-major ``(V, D)`` storage array: hot ids
    from the cache, cold ids from main storage.  Values are identical
    either way (write-through invariant), so the result is bit-identical
    to a single-table gather regardless of placement."""
    cold = _gather_rows(data, spec.flatten(ids), impl=impl)
    if hot_rows is None or hot_rows.shape[0] == 0:
        return cold
    return _merge_hot(cold, hot_rows, slot_of, ids, impl=impl)


def sharded_update(data, ids, row_grads, lr, *, spec: RoutingSpec,
                   dedup: bool = True):
    """Routed push into shard-major storage: one COO scatter-add of
    ``-lr * row_grads`` at the ids' storage slots (a new array).

    With ``dedup`` the (ids, grads) stream is first reduced to one summed
    row per distinct id (``dedup_rows``); padding slots carry the id
    ``spec.vocab`` and are dropped, so per-row accumulation order (and
    bits) matches the single-table scatter exactly.  Returns
    ``(new_data, pushed_ids, summed_updates)``."""
    ids = ids.reshape(-1)
    g = row_grads.reshape(-1, spec.dim)
    if dedup:
        ids, g = dedup_rows(ids, g, fill_id=spec.vocab)
    u = (-lr * g).to(data.dtype)
    live = ids < spec.vocab
    return add_rows(data, spec.flatten(ids[live]), u[live]), ids, u


def _client_update(ids, row_grads, lr, *, vocab: int, dim: int,
                   dedup: bool = True):
    """Client half of a push: dedup + pre-scale, exactly as
    :func:`sharded_update` does — the shard's ``+=`` of the result is
    then the same IEEE add as the oracle's scatter.  Returns
    ``(pushed_ids, updates)`` (padding ids carry ``vocab``)."""
    ids = ids.reshape(-1)
    g = row_grads.reshape(-1, dim)
    if dedup:
        ids, g = dedup_rows(ids, g, fill_id=vocab)
    return ids, (-lr * g).to(torch.float32)


def _hot_apply(hot_rows, slot_of, ids, updates):
    """Write-through: the cache with the already-summed push updates
    added to the cached copies of hot rows (cold / padding ids drop), as
    a new tensor."""
    slot = slot_of[ids.long()]
    hit = slot >= 0
    return add_rows(hot_rows, slot[hit], updates[hit])


def _merge_hot(cold, hot_rows, slot_of, ids, *, impl: str = "auto"):
    """Overlay hot-cache rows onto cold rows (selection only — bit-neutral
    under the write-through invariant); the cache gather is the
    embedding-bag kernel's."""
    slot = slot_of[ids.long()]
    hot = _gather_rows(hot_rows, slot.clamp_min(0), impl=impl)
    return torch.where((slot >= 0)[..., None], hot, cold)


def _sync(device: torch.device) -> None:
    """Wait for the work this thread queued on ``device`` — its current
    stream only, not the other threads' streams."""
    if device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()


def _host_ids(ids) -> np.ndarray:
    if isinstance(ids, torch.Tensor):
        return ids.detach().cpu().numpy()
    return np.asarray(ids)


class ShardedTable:
    """One logical embedding table, vocab-partitioned across N PS shards
    behind a :class:`~repro_torch.ps.transport.Transport`.

    Parameters:
      seed: ``None`` (→ zeros) or the seed of a ``torch.Generator`` that
        draws the initial table ``N(0, 1) * init_scale`` (default scale
        ``dim**-0.5``) on the CPU.
      transport: ``None`` (→ in-process queue backend), ``"inproc"`` /
        ``"multiproc"``, or a :class:`Transport` instance.  Shard ``s``
        becomes endpoint ``s`` owning bucket ``s`` (its slab).
      monitor: optional :class:`repro_torch.data.cache.AccessMonitor` —
        every pull records row-access counts.
      telemetry: optional :class:`repro_torch.ps.telemetry.PSTelemetry` —
        per-shard pull/push bytes + wall-time accounting.
      hot_capacity: row capacity of the hot cache (the cache fills only
        on re-pin).
      rpc_latency_s: extra simulated per-op worker↔PS latency on top of
        the transport's real cost.
      device: where pulled rows, the hot cache and its slot map live
        (default ``cuda``); the shard slabs stay in host memory.
      impl: the hot-cache gather's embedding-bag implementation
        (``auto`` | ``ref`` | ``cuda``, as ``kernels.ops.embedding_bag``).

    ``hot_pulls`` counts the pulls that found the cache non-empty — each
    gathers from the cache once.

    Thread-safety: pulls snapshot the (hot cache, slot map) pair under
    ``_mu``; pushes and hot-cache re-pins serialize on ``_update_mu`` so
    a re-pin landing mid-push can neither lose nor double-apply a
    write-through.  The cache is replaced, never written in place, so a
    pull reading a snapshot never sees a torn row (pulls may observe a
    push's shard-side effect before its hot write-through, the same
    bounded staleness the async client already trades on).
    """

    def __init__(self, vocab: int, dim: int, num_shards: int,
                 seed: int | None = None, *, partition: str = "mod",
                 dtype=torch.float32, monitor=None, telemetry=None,
                 hot_capacity: int = 4096, rpc_latency_s: float = 0.0,
                 init_scale: float | None = None,
                 transport: str | Transport | None = None, device=None,
                 impl: str = "auto"):
        self.spec = RoutingSpec(vocab, dim, num_shards, partition)
        self.monitor = monitor
        self.telemetry = telemetry
        self.hot_capacity = int(hot_capacity)
        self.rpc_latency_s = float(rpc_latency_s)
        self.dtype = dtype
        self.device = resolve_device(device)
        self.impl = impl
        self.hot_pulls = 0
        self._mu = threading.Lock()
        self._update_mu = threading.RLock()
        self.transport = make_transport(transport)
        for s in range(num_shards):
            self.transport.add_shard(s, dim=dim, optimizer="none")
        if seed is not None:
            scale = dim**-0.5 if init_scale is None else init_scale
            g = torch.Generator().manual_seed(seed)
            self._load_dense(torch.randn((vocab, dim), generator=g,
                                         dtype=dtype) * scale)
        else:
            self._load_dense(np.zeros((vocab, dim), np.float32))
        # hot-row cache: empty until the first re-pin
        self.hot_rows = torch.zeros((0, dim), dtype=dtype, device=self.device)
        self.slot_of = torch.full((vocab + 1,), -1, dtype=torch.int32,
                                  device=self.device)
        # simulated storage-tier placement (row granularity, per shard);
        # everything starts cold, matching a freshly loaded table
        self.tiers = [np.full((r,), TIER_DISK, np.int8)
                      for r in self.spec.shard_rows]
        # host copy of the slot map for O(ids) hot-hit accounting — counts
        # rows actually served from the cache, not merely DEVICE-coded
        self._slot_np = np.full((vocab + 1,), -1, np.int32)
        self._cache_active = False

    # --- construction / inspection ------------------------------------
    def _load_dense(self, dense) -> None:
        """Ship a vocab-order ``(V, D)`` table to the shards as slabs."""
        dense_np = torch.as_tensor(dense).detach().to(
            "cpu", torch.float32).numpy()
        for s in range(self.spec.num_shards):
            self.transport.request(s, {
                "op": "create", "bucket": s,
                "rows": dense_np[self.spec.global_rows(s)]})

    @classmethod
    def from_dense(cls, table, num_shards: int, *, partition: str = "mod",
                   **kw) -> "ShardedTable":
        """A table holding ``table`` (a ``(V, D)`` tensor or array)."""
        if not isinstance(table, torch.Tensor):
            table = torch.from_numpy(np.array(table))
        t = cls(table.shape[0], table.shape[1], num_shards,
                partition=partition, dtype=table.dtype, **kw)
        t._load_dense(table)
        return t

    def to_dense(self):
        """Reassemble the logical ``(V, D)`` table on the host."""
        dense = np.empty((self.vocab, self.dim), np.float32)
        replies = self.transport.request_many(
            [(s, {"op": "snapshot", "bucket": s})
             for s in range(self.num_shards)])
        for s, rep in enumerate(replies):
            dense[self.spec.global_rows(s)] = rep["rows"]
        return torch.from_numpy(dense).to(self.dtype)

    @property
    def shards(self) -> list:
        """Per-shard slab snapshots (local-row order), on the host."""
        return [torch.from_numpy(rep["rows"]).to(self.dtype)
                for rep in self.transport.request_many(
                    [(s, {"op": "snapshot", "bucket": s})
                     for s in range(self.num_shards)])]

    @property
    def vocab(self) -> int:
        return self.spec.vocab

    @property
    def dim(self) -> int:
        return self.spec.dim

    @property
    def num_shards(self) -> int:
        return self.spec.num_shards

    # --- transport routing ----------------------------------------------
    def _shard_messages(self, op: str, ids_flat: np.ndarray,
                        payload: np.ndarray | None = None, **extra):
        """Group a flat id stream by owner shard into per-shard messages.
        Returns ``(messages, segments)`` where ``segments[i]`` are the
        positions in ``ids_flat`` message ``i`` covers."""
        owner, local = self.spec.route(ids_flat)
        order = np.argsort(owner, kind="stable")
        counts = np.bincount(owner, minlength=self.spec.num_shards)
        msgs, segs, start = [], [], 0
        for s in range(self.spec.num_shards):
            n = int(counts[s])
            if n == 0:
                continue
            seg = order[start:start + n]
            start += n
            msg = {"op": op, "buckets": np.full((n,), s, np.int64),
                   "ids": local[seg], **extra}
            if payload is not None:
                msg["updates" if op == "add" else "grads"] = payload[seg]
            msgs.append((s, msg))
            segs.append(seg)
        return msgs, segs

    def _fetch(self, ids_flat: np.ndarray) -> np.ndarray:
        """Raw routed pull over the transport (no metering, no cache) —
        rows in ``ids_flat`` order, on the host."""
        msgs, segs = self._shard_messages("pull", ids_flat)
        out = np.empty((ids_flat.size, self.dim), np.float32)
        for seg, rep in zip(segs, self.transport.request_many(msgs)):
            out[seg] = rep["rows"]
        return out

    # --- PS operations -------------------------------------------------
    def _account(self, op: str, ids_np: np.ndarray, seconds: float,
                 bytes_per_row: int) -> None:
        if self.telemetry is None:
            return
        owner, local = self.spec.route(ids_np)
        owner, local = owner.ravel(), local.ravel()
        S = self.spec.num_shards
        per_shard = np.bincount(owner, minlength=S)
        hot = None
        if self._cache_active:
            hot = np.bincount(
                owner[self._slot_np[ids_np.ravel()] >= 0], minlength=S)
        self.telemetry.record(op, rows=per_shard,
                              bytes_=per_shard * bytes_per_row,
                              seconds=seconds, hot_rows=hot)

    def _check_ids(self, ids_np: np.ndarray) -> None:
        if ids_np.size and (ids_np.min() < 0 or ids_np.max() >= self.vocab):
            raise ValueError(
                f"ids out of range for vocab={self.vocab}: "
                f"[{ids_np.min()}, {ids_np.max()}]")

    def pull(self, ids):
        """PS pull: fetch the touched rows.  ``ids (...,)`` (host array or
        tensor) → ``(..., D)`` on the table's device."""
        t0 = time.perf_counter()
        ids_np = _host_ids(ids)
        self._check_ids(ids_np)
        if self.monitor is not None:
            self.monitor.record(ids_np)
        cold = self._fetch(ids_np.ravel().astype(np.int64))
        out = torch.from_numpy(cold.reshape(ids_np.shape + (self.dim,))).to(
            self.device, self.dtype)
        with self._mu:   # coherent (cache, slot-map) snapshot
            hot, slot = self.hot_rows, self.slot_of
            if hot.shape[0]:
                self.hot_pulls += 1
        if hot.shape[0]:
            ids_t = torch.from_numpy(ids_np.astype(np.int64)).to(self.device)
            out = _merge_hot(out, hot, slot, ids_t, impl=self.impl)
        _sync(self.device)
        if self.rpc_latency_s:
            time.sleep(self.rpc_latency_s)
        self._account("pull", ids_np, time.perf_counter() - t0,
                      self.spec.dim * out.element_size())
        return out

    def push(self, ids, row_grads, *, lr: float, dedup: bool = True):
        """PS push: apply ``-lr * row_grads`` at the owning shards (and
        write through to the hot cache, keeping the two bit-identical).

        The gradients come to the host, where the dedup + ``-lr``
        pre-scale run (identical to the oracle's :func:`sharded_update`
        prologue); shards apply the summed per-row updates with a plain
        f32 add."""
        t0 = time.perf_counter()
        ids_np = _host_ids(ids)
        self._check_ids(ids_np)
        grads = torch.as_tensor(row_grads).detach().cpu()
        pushed_ids, updates = _client_update(
            torch.from_numpy(ids_np), grads, lr, vocab=self.vocab,
            dim=self.dim, dedup=dedup)
        pushed_np = pushed_ids.numpy()
        u_np = updates.numpy()
        live = pushed_np < self.vocab        # drop dedup padding slots
        wire_ids = pushed_np[live].astype(np.int64)
        with self._update_mu:
            msgs, _ = self._shard_messages("add", wire_ids,
                                           payload=u_np[live])
            self.transport.request_many(msgs)
            # write-through must see the *current* cache/slot-map (a
            # re-pin serializes on _update_mu, so it can't land between
            # the shard apply and this update)
            with self._mu:
                if self.hot_rows.shape[0]:
                    hot = _hot_apply(
                        self.hot_rows, self.slot_of,
                        pushed_ids.to(self.device),
                        updates.to(self.device, self.dtype))
                    _sync(self.device)
                    self.hot_rows = hot
        if self.rpc_latency_s:
            time.sleep(self.rpc_latency_s)
        if self.telemetry is not None:
            itemsize = np.dtype(np.float32).itemsize
            # the wire carries one summed row per distinct id when
            # deduping; raw duplicates otherwise
            acct_ids = wire_ids if dedup else ids_np
            self._account("push", acct_ids, time.perf_counter() - t0,
                          self.spec.dim * itemsize + ids_np.itemsize)
        return self

    # --- tier placement (written by TierPlacer) -------------------------
    def set_tiers(self, global_tiers: np.ndarray) -> dict:
        """Install a per-row tier assignment (array of
        ``repro_torch.data.cache.Tier`` over the *global* vocab) into the
        per-shard tier arrays; returns per-tier row counts."""
        from repro_torch.data.cache import Tier

        codes = np.full((self.vocab,), TIER_DISK, np.int8)
        codes[global_tiers == Tier.DEVICE] = TIER_DEVICE
        codes[global_tiers == Tier.HOST] = TIER_HOST
        for s in range(self.num_shards):
            self.tiers[s] = codes[self.spec.global_rows(s)]
        return {
            "device_rows": int((codes == TIER_DEVICE).sum()),
            "host_rows": int((codes == TIER_HOST).sum()),
            "disk_rows": int((codes == TIER_DISK).sum()),
        }

    def install_hot_rows(self, hot_ids: np.ndarray) -> int:
        """Re-pin: load ``hot_ids`` (truncated to capacity) into the hot
        cache on the table's device and rebuild the slot map.  Returns
        the cached row count."""
        hot_ids = np.asarray(hot_ids, np.int64).ravel()[:self.hot_capacity]
        if hot_ids.size == 0:
            return 0
        slot = np.full((self.vocab + 1,), -1, np.int32)
        slot[hot_ids] = np.arange(hot_ids.size, dtype=np.int32)
        # the cache keeps its fixed capacity whatever the hot set's size
        pad = np.zeros((self.hot_capacity,), np.int64)
        pad[:hot_ids.size] = hot_ids
        with self._update_mu:    # no push between fetch and install
            rows = torch.from_numpy(self._fetch(pad)).to(self.device,
                                                         self.dtype)
            slot_t = torch.from_numpy(slot).to(self.device)
            _sync(self.device)   # complete on the device before publishing
            with self._mu:
                self.hot_rows = rows
                self.slot_of = slot_t
                self._slot_np = slot
                self._cache_active = True
        return int(hot_ids.size)

    def demote_storage(self) -> None:
        """Tiering hint: shard slabs are the cold tier once the hot cache
        covers the head of the distribution.  Client-side this is a
        broadcast notification — a no-op on the CPU shard servers."""
        self.transport.request_many(
            [(s, {"op": "demote"}) for s in sorted(
                self.transport.live_shards)])

    def close(self) -> None:
        """Shut the shard endpoints down (idempotent)."""
        self.transport.close()
        if self.telemetry is not None:
            self.telemetry.close()
