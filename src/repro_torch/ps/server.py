"""PS shard server — the state + event loop one parameter-server worker
runs (HeterPS §3's CPU-PS tier as a real process; copy of
``repro.ps.server``).

A shard owns a set of **buckets** (contiguous vocab slabs, the unit of
placement, migration and replication).  Each bucket carries its slab
rows, the PS-hosted optimizer state (Adagrad / Adam accumulators — the
client's dedup-before-push guarantees one update per row per step, so
adaptive statistics are well-defined), and an ``acked`` update counter
(what "the shard's last acked state" means for replica recovery).

This module is deliberately **numpy-only** — it imports no torch, and
``repro_torch``'s package init is lazy — so a spawned shard process
(``repro_torch.ps.transport.MultiprocTransport``) starts in milliseconds
instead of paying the torch import.  The arithmetic is still bit-exact
against the client: a routed gather is a row copy either way, and the f32
``+=`` of a client-computed update is the same IEEE add as the client's
scatter-add (pinned in tests/test_torch_ps.py).

The wire protocol is plain dicts with numpy payloads (picklable for the
multiprocess transport, zero-copy for the in-process one):

==========  =====================================  =======================
op          request fields                         reply
==========  =====================================  =======================
create      bucket, rows                           ok
pull        buckets (k,), ids (k,) local           rows (k, D)
add         buckets, ids, updates                  ok, acked  (pre-scaled)
grad        buckets, ids, grads, lr [, replica]    ok, acked  (PS optimizer)
snapshot    bucket                                 rows, opt, acked
install     bucket, rows, opt, acked               ok
drop        bucket                                 ok
stats       —                                      buckets, rows, counters
obs         —                                      events (trace drain), pid
demote      —                                      ok (tiering hint, no-op)
shutdown    —                                      ok (event loop exits)
==========  =====================================  =======================

Observability: every handled op records a span into the server's *own*
:class:`~repro_torch.obs.trace.TraceBuffer` (gated on the session obs switch,
which spawned workers inherit via ``REPRO_OBS``); the ``obs`` op drains
that buffer so the client side can merge worker timelines — stamped with
the worker's pid — into the main process trace
(:meth:`repro_torch.ps.transport.Transport.collect_obs`).

Every reply carries ``shard``; failures come back as ``{"err": ...}``
instead of killing the event loop (a bad request must not look like a
crashed shard to the failure detector).

At-most-once execution: requests may carry a transport-assigned ``seq``.
The server echoes it into the reply and keeps a bounded seq→reply cache
(:data:`REPLY_CACHE_SIZE` entries), so a *retried* request — the
transport resends after a timeout or an injected fault — is answered
from the cache without re-applying.  That is what makes retrying a
non-idempotent ``grad`` push safe: the update lands exactly once no
matter how many times the message arrives.
"""

from __future__ import annotations

import os
import traceback
from collections import OrderedDict

import numpy as np

from repro_torch.obs import trace as obs_trace

#: retained seq→reply entries per shard — a few times the deepest
#: request pipeline any one client keeps in flight, tiny vs slab memory
REPLY_CACHE_SIZE = 16

#: optimizer names accepted by :class:`ShardServer` (``"none"`` applies
#: pre-scaled updates verbatim — the client-side-SGD mode ShardedTable
#: uses to stay bit-exact with the ``SparseEmbedding`` oracle).
OPTIMIZERS = ("none", "sgd", "adagrad", "adam")


def make_opt_state(optimizer: str, rows: int, dim: int) -> dict:
    """Fresh per-bucket optimizer slots (f32, one entry per slab row)."""
    if optimizer in ("none", "sgd"):
        return {}
    if optimizer == "adagrad":
        return {"acc": np.zeros((rows, dim), np.float32)}
    if optimizer == "adam":
        return {"m": np.zeros((rows, dim), np.float32),
                "v": np.zeros((rows, dim), np.float32),
                "t": np.zeros((rows,), np.int64)}
    raise ValueError(f"unknown optimizer {optimizer!r}")


def apply_grads(optimizer: str, hyper: dict, slab: np.ndarray, opt: dict,
                local: np.ndarray, grads: np.ndarray, lr: float) -> None:
    """Apply one deduped gradient batch in place (one update per row).

    Deterministic: replaying the same update stream on a replica bucket
    reproduces the primary's slab and optimizer state bit-for-bit, which
    is what makes synchronous replication → promotion lossless.
    """
    g = grads.astype(np.float32, copy=False)
    lr32 = np.float32(lr)
    if optimizer in ("none",):
        # pre-scaled updates: slab[local] += grads (grads already -lr·g)
        np.add.at(slab, local, g)
    elif optimizer == "sgd":
        np.add.at(slab, local, -lr32 * g)
    elif optimizer == "adagrad":
        acc = opt["acc"]
        acc[local] += g * g
        slab[local] += -lr32 * g / (np.sqrt(acc[local])
                                    + np.float32(hyper.get("eps", 1e-8)))
    elif optimizer == "adam":
        b1 = np.float32(hyper.get("beta1", 0.9))
        b2 = np.float32(hyper.get("beta2", 0.999))
        eps = np.float32(hyper.get("eps", 1e-8))
        t = opt["t"]
        t[local] += 1
        tl = t[local].astype(np.float32)[:, None]
        m = opt["m"][local] * b1 + (1 - b1) * g
        v = opt["v"][local] * b2 + (1 - b2) * g * g
        opt["m"][local] = m
        opt["v"][local] = v
        m_hat = m / (1 - b1 ** tl)
        v_hat = v / (1 - b2 ** tl)
        slab[local] += -lr32 * m_hat / (np.sqrt(v_hat) + eps)
    else:
        raise ValueError(f"unknown optimizer {optimizer!r}")


class ShardServer:
    """One PS shard's state and request handler.

    The same object backs both transports: the in-process backend calls
    :meth:`handle` directly (behind a queue), the multiprocess backend
    runs it inside :func:`shard_main`'s event loop.
    """

    def __init__(self, shard_id: int, dim: int, *, optimizer: str = "none",
                 hyper: dict | None = None):
        if optimizer not in OPTIMIZERS:
            raise ValueError(f"optimizer must be one of {OPTIMIZERS}, "
                             f"got {optimizer!r}")
        self.shard_id = shard_id
        self.dim = dim
        self.optimizer = optimizer
        self.hyper = dict(hyper or {})
        #: bucket id → {"rows": (n, D) f32, "opt": {...}, "acked": int}
        self.buckets: dict[int, dict] = {}
        self.counters = {"pulls": 0, "pushes": 0, "replica_pushes": 0,
                         "pull_rows": 0, "push_rows": 0,
                         "dedup_replays": 0}
        #: per-server trace ring — drained over the wire by the "obs" op
        self.trace = obs_trace.TraceBuffer(capacity=16384)
        #: seq → reply, bounded LRU — at-most-once retry semantics
        self._replies: OrderedDict[int, dict] = OrderedDict()

    # --- per-op handlers -------------------------------------------------
    def _bucket(self, b: int) -> dict:
        try:
            return self.buckets[int(b)]
        except KeyError:
            raise KeyError(f"shard {self.shard_id} does not own bucket {b}")

    def _grouped(self, buckets: np.ndarray, ids: np.ndarray):
        """Yield (bucket_state, local_ids, segment_index) per distinct
        bucket, preserving a stable order for deterministic replays."""
        buckets = np.asarray(buckets)
        order = np.argsort(buckets, kind="stable")
        bounds = np.flatnonzero(np.diff(buckets[order])) + 1
        for seg in np.split(order, bounds):
            yield self._bucket(buckets[seg[0]]), ids[seg], seg

    def handle(self, msg: dict) -> dict:
        op = msg["op"]
        if op == "obs":
            # trace drain — not itself spanned (a span recorded mid-drain
            # would straddle the buffer handoff)
            return {"shard": self.shard_id, "ok": True,
                    "pid": os.getpid(), "events": self.trace.drain()}
        with obs_trace.span(f"ps.shard.{op}", "ps", buffer=self.trace,
                            shard=self.shard_id):
            return self._handle_op(op, msg)

    def _handle_op(self, op: str, msg: dict) -> dict:
        out: dict = {"shard": self.shard_id, "ok": True}
        if op == "pull":
            ids = msg["ids"]
            rows = np.empty((ids.shape[0], self.dim), np.float32)
            for st, local, seg in self._grouped(msg["buckets"], ids):
                rows[seg] = st["rows"][local]
            self.counters["pulls"] += 1
            self.counters["pull_rows"] += int(ids.shape[0])
            out["rows"] = rows
        elif op in ("add", "grad"):
            ids = msg["ids"]
            payload = msg["updates"] if op == "add" else msg["grads"]
            lr = float(msg.get("lr", 0.0))
            acked = {}
            for st, local, seg in self._grouped(msg["buckets"], ids):
                apply_grads(self.optimizer if op == "grad" else "none",
                            self.hyper, st["rows"], st["opt"], local,
                            payload[seg], lr)
                st["acked"] += 1
                acked[int(msg["buckets"][seg[0]])] = st["acked"]
            key = "replica_pushes" if msg.get("replica") else "pushes"
            self.counters[key] += 1
            if not msg.get("replica"):
                self.counters["push_rows"] += int(ids.shape[0])
            out["acked"] = acked
        elif op == "create":
            rows = np.array(msg["rows"], np.float32, copy=True)
            self.buckets[int(msg["bucket"])] = {
                "rows": rows, "acked": 0,
                "opt": make_opt_state(self.optimizer, rows.shape[0],
                                      self.dim)}
        elif op == "snapshot":
            st = self._bucket(msg["bucket"])
            out.update(rows=st["rows"].copy(),
                       opt={k: v.copy() for k, v in st["opt"].items()},
                       acked=st["acked"])
        elif op == "install":
            self.buckets[int(msg["bucket"])] = {
                "rows": np.array(msg["rows"], np.float32, copy=True),
                "opt": {k: np.array(v, copy=True)
                        for k, v in msg["opt"].items()},
                "acked": int(msg["acked"])}
        elif op == "drop":
            self.buckets.pop(int(msg["bucket"]), None)
        elif op == "stats":
            out.update(
                buckets=sorted(self.buckets),
                acked={b: st["acked"] for b, st in self.buckets.items()},
                rows=int(sum(st["rows"].shape[0]
                             for st in self.buckets.values())),
                counters=dict(self.counters))
        elif op in ("demote", "shutdown"):
            pass  # tiering hint / loop control — nothing to do state-side
        else:
            raise ValueError(f"unknown op {op!r}")
        return out

    def safe_handle(self, msg: dict) -> dict:
        """:meth:`handle` with failures encoded in the reply — a bad
        request must not be indistinguishable from a dead shard.

        If ``msg`` carries a ``seq`` already answered, the cached reply
        is replayed **without re-executing** the op (at-most-once
        semantics for transport retries); fresh replies echo the seq and
        enter the bounded cache — error replies too, so a retried bad
        request fails identically instead of re-raising server-side.
        """
        seq = msg.get("seq")
        if seq is not None and seq in self._replies:
            self.counters["dedup_replays"] += 1
            return self._replies[seq]
        try:
            reply = self.handle(msg)
        except Exception:
            reply = {"shard": self.shard_id, "ok": False,
                     "err": traceback.format_exc(limit=8)}
        if seq is not None:
            reply["seq"] = seq
            self._replies[seq] = reply
            while len(self._replies) > REPLY_CACHE_SIZE:
                self._replies.popitem(last=False)
        return reply


def shard_main(conn, shard_id: int, dim: int, optimizer: str = "none",
               hyper: dict | None = None) -> None:
    """Event loop of a shard worker process: recv → handle → send until a
    ``shutdown`` op (clean exit) or a closed pipe (client died)."""
    server = ShardServer(shard_id, dim, optimizer=optimizer, hyper=hyper)
    if obs_trace.enabled():
        # name this worker's pid lane in the merged Perfetto trace (only
        # here — an in-process server shares the client's pid)
        obs_trace.label_process(f"ps-shard-{shard_id}", buffer=server.trace)
    while True:
        try:
            msg = conn.recv()
        except (EOFError, OSError):
            return               # client side went away — nothing to flush
        reply = server.safe_handle(msg)
        try:
            conn.send(reply)
        except (BrokenPipeError, OSError):
            return
        if msg.get("op") == "shutdown":
            conn.close()
            return
