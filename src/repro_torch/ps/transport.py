"""Pluggable worker↔PS transport (HeterPS §3's network hop, made real;
copy of ``repro.ps.transport``).

Every PS consumer (:class:`~repro_torch.ps.sharding.ShardedTable`,
:class:`~repro_torch.ps.elastic.ElasticPSFleet`, and through them
``PSClient``) speaks the message protocol of
:mod:`repro_torch.ps.server` to shard endpoints through one of two backends:

* :class:`InProcTransport` — shards are :class:`~repro_torch.ps.server.
  ShardServer` objects behind per-shard mailbox queues in this process.
  Deterministic and copy-free: the backend for tests, CI and the
  bit-exact oracle path.
* :class:`MultiprocTransport` — each shard is a **real OS process**
  running :func:`~repro_torch.ps.server.shard_main` behind a duplex
  ``multiprocessing`` connection (an AF_UNIX socketpair / OS pipe — the
  same framing a TCP deployment would use).  Requests to distinct
  shards fly in parallel (`request_many` sends to every shard before
  collecting replies); requests to one shard are serialized by a
  per-shard lock, which is also what makes the transport safe under
  ``PSClient``'s puller/pusher thread pair.

Failure semantics are part of the contract, and they come in **three**
grades:

* a shard that answers with ``{"err": ...}`` raises
  :class:`PSShardError` — the shard is alive, the request was bad;
* a shard that is *slow* (poll deadline expired but the worker process
  is still alive, an injected transient fault, a stale/duplicated
  reply) raises :class:`PSShardSlow` **internally** — the base-class
  retry loop consumes it: exponential backoff + jitter, optional hedged
  resends for idempotent ops, and escalation to ``PSShardLost`` only
  after ``RetryPolicy.max_attempts``;
* a shard that is *gone* (killed, crashed, closed pipe, or escalated
  from slow) raises :class:`PSShardLost` — what the elastic fleet's
  recovery path catches.  On the multiprocess backend the message
  carries the op name, elapsed time and the worker's exit code, so a
  hung worker is never misreported as a dead one.

Retries are safe for **every** op — including non-idempotent ``grad``
pushes — because each logical request carries a transport-assigned
``seq`` and :class:`~repro_torch.ps.server.ShardServer` keeps a bounded
seq→reply cache: a resent request is answered from the cache without
re-applying (classic at-most-once RPC).  Stale replies (a timed-out
attempt's answer arriving late, or a fault-injected duplicate) are
discarded by seq mismatch.

``MultiprocTransport`` additionally runs a **heartbeat** thread: dead
worker processes are detected within ``heartbeat_s`` and reported
through ``on_shard_lost`` (the elastic fleet hooks this to recover
proactively) instead of on the next pull/push touch.

``kill()`` is the fault injector: it terminates the worker *without*
any flush, so whatever the shard acked last is exactly what a replica
must reproduce.  :class:`repro_torch.ps.faults.FaultInjector` wraps any
transport for deterministic chaos (delays, dropped/dup replies,
transient recv errors, scheduled crashes).
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import random
import threading
import time
from collections import deque

from repro_torch.obs import trace as obs_trace
from repro_torch.ps.server import ShardServer, shard_main


class PSShardError(RuntimeError):
    """The shard processed the request and reported a failure."""


class PSShardLost(RuntimeError):
    """The shard is gone (killed, crashed, or escalated from slow) — the
    request may or may not have been applied.  Recovery promotes the
    replica."""


class PSShardSlow(RuntimeError):
    """Transient: the shard did not answer in time but its process is
    (or may be) alive — retryable.  Consumed by the transport's retry
    loop and escalated to :class:`PSShardLost` after
    ``RetryPolicy.max_attempts``; callers normally never see it."""


#: ops whose replies carry no state change on the shard — safe to hedge
#: (race a duplicate in-flight request) even *without* the seq cache
IDEMPOTENT_OPS = frozenset(
    {"pull", "snapshot", "stats", "ping", "demote"})


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Per-request retry/hedging knobs shared by every backend.

    ``max_attempts`` counts the first try; ``backoff_s`` doubles (times
    ``backoff_mult``) up to ``max_backoff_s``, with up to ``jitter``
    fraction of uniform extra sleep so a fleet of clients doesn't
    retry in lockstep.  ``hedge_s`` (multiproc only): after this many
    seconds without a reply to an *idempotent* op, resend the same
    request (same seq) so the duplicate races the original — first
    reply wins, the loser is discarded by seq.
    """

    max_attempts: int = 3
    backoff_s: float = 0.05
    backoff_mult: float = 2.0
    max_backoff_s: float = 1.0
    jitter: float = 0.5
    hedge_s: float | None = None


def _check(reply: dict, shard_id: int) -> dict:
    if reply.get("err"):
        raise PSShardError(
            f"shard {shard_id} failed request:\n{reply['err']}")
    return reply


def _raise_lost(lost: set[int]):
    err = PSShardLost(f"shards lost mid-request: {sorted(lost)}")
    err.shard_ids = lost
    raise err


class Transport:
    """Abstract worker↔PS message channel.

    ``add_shard`` brings a new endpoint up (the *elastic join* primitive),
    ``request``/``request_many`` are blocking RPCs, ``stop_shard`` is a
    graceful leave, ``kill_shard`` a hard failure.  Implementations keep
    per-shard FIFO ordering — the protocol relies on it (an ``install``
    sent before a ``grad`` must be applied first).

    Backends implement the single-attempt primitive :meth:`_attempt`;
    the base class owns the retry loop (:meth:`request`): it assigns the
    request ``seq``, holds the backend's per-shard lock across all
    attempts (so resends stay FIFO with respect to concurrent clients),
    consumes :class:`PSShardSlow`, discards stale replies by seq, and
    escalates to :class:`PSShardLost` when the policy is exhausted.

    ``on_shard_lost`` (settable) is called with a shard id when a
    failure *detector* (the multiproc heartbeat) notices a dead worker
    out-of-band; ``counters`` accumulates retry/hedge/heartbeat
    diagnostics (also mirrored as obs instants when enabled).
    """

    name = "abstract"

    def __init__(self, *, retry: RetryPolicy | None = None,
                 retry_seed: int = 0):
        self.retry = retry if retry is not None else RetryPolicy()
        self._retry_rng = random.Random(retry_seed)
        #: failure-detector callback: fn(shard_id) — set by the fleet
        self.on_shard_lost = None
        self.counters = {"retries": 0, "hedges": 0, "escalations": 0,
                         "stale_replies": 0, "heartbeat_misses": 0}
        self._seq = itertools.count(1)

    # --- backend primitives ----------------------------------------------
    def _attempt(self, shard_id: int, msg: dict) -> dict:
        """One send→recv roundtrip.  Raise :class:`PSShardSlow` for a
        retryable condition, :class:`PSShardLost` for a dead endpoint."""
        raise NotImplementedError

    def _shard_lock(self, shard_id: int):
        """Context manager serializing requests to one shard — held
        across *all* attempts of one logical request."""
        return contextlib.nullcontext()

    def _mark_lost(self, shard_id: int) -> None:
        """Drop backend state for an escalated shard (reap/forget)."""

    def add_shard(self, shard_id: int, *, dim: int, optimizer: str = "none",
                  hyper: dict | None = None) -> None:
        raise NotImplementedError

    # --- retrying RPC ----------------------------------------------------
    def _bump(self, key: str, shard_id: int, detail: str = "") -> None:
        self.counters[key] += 1
        if obs_trace.enabled():
            obs_trace.instant(f"ps.transport.{key}", "ps", shard=shard_id,
                              detail=detail)

    def request(self, shard_id: int, msg: dict) -> dict:
        msg = dict(msg)
        msg.setdefault("seq", next(self._seq))
        with self._shard_lock(shard_id):
            return self._request_locked(shard_id, msg)

    def _request_locked(self, shard_id: int, msg: dict) -> dict:
        """The retry loop (per-shard lock held, seq already assigned)."""
        pol = self.retry
        backoff = pol.backoff_s
        last: Exception | None = None
        for attempt in range(max(1, pol.max_attempts)):
            if attempt:
                self._bump("retries", shard_id,
                           f"op={msg.get('op')} attempt={attempt + 1}")
                time.sleep(backoff
                           * (1.0 + pol.jitter * self._retry_rng.random()))
                backoff = min(backoff * pol.backoff_mult, pol.max_backoff_s)
            try:
                reply = self._attempt(shard_id, msg)
            except PSShardSlow as e:
                last = e
                continue
            if reply.get("seq", msg["seq"]) != msg["seq"]:
                # a stale/duplicated reply from an earlier attempt (or a
                # fault-injected dup) — discard and go again
                self._bump("stale_replies", shard_id)
                last = PSShardSlow(
                    f"stale reply seq={reply.get('seq')} "
                    f"(expected {msg['seq']})")
                continue
            return reply
        self._bump("escalations", shard_id, f"op={msg.get('op')}")
        self._mark_lost(shard_id)
        raise PSShardLost(
            f"shard {shard_id} lost: op={msg.get('op')!r} escalated after "
            f"{max(1, pol.max_attempts)} attempt(s): {last}") from last

    def request_many(self, pairs: list[tuple[int, dict]]) -> list[dict]:
        """Issue several (shard, msg) requests; replies in call order.

        Partial-failure contract (what elastic recovery leans on): every
        *live* shard in ``pairs`` has processed its message and had its
        reply consumed before :class:`PSShardLost` is raised for the dead
        ones — the exception carries ``shard_ids``, and no reply is left
        in flight to desynchronize a later request.  Default
        implementation is sequential; backends override to overlap
        shards.
        """
        replies, lost = [], set()
        for s, m in pairs:
            try:
                replies.append(self.request(s, m))
            except PSShardLost:
                lost.add(s)
                replies.append(None)
        if lost:
            _raise_lost(lost)
        return replies

    def stop_shard(self, shard_id: int) -> None:
        raise NotImplementedError

    def kill_shard(self, shard_id: int) -> None:
        raise NotImplementedError

    @property
    def live_shards(self) -> set[int]:
        raise NotImplementedError

    def collect_obs(self) -> list[dict]:
        """Drain every live shard's trace buffer into the caller's global
        trace buffer (:data:`repro_torch.obs.trace.BUFFER`) — multiproc worker
        events arrive stamped with the worker's pid, giving the merged
        Chrome trace one lane per shard process.  Best-effort: a shard
        lost mid-drain just contributes nothing.  No-op (and no RPCs)
        when observability is disabled."""
        if not obs_trace.enabled():
            return []
        events: list[dict] = []
        for s in sorted(self.live_shards):
            try:
                reply = self.request(s, {"op": "obs"})
            except (PSShardError, PSShardLost):
                continue
            events.extend(reply.get("events", ()))
        obs_trace.BUFFER.extend(events)
        return events

    def _drain_shard_obs(self, shard_id: int) -> None:
        """Best-effort trace drain of one shard (graceful-stop prologue,
        so a leaving shard's spans survive into the merged trace)."""
        if not obs_trace.enabled():
            return
        try:
            reply = self.request(shard_id, {"op": "obs"})
        except (PSShardError, PSShardLost):
            return
        obs_trace.BUFFER.extend(reply.get("events", ()))

    def close(self) -> None:
        self.collect_obs()
        for s in sorted(self.live_shards):
            try:
                self.stop_shard(s)
            except PSShardLost:
                pass


class InProcTransport(Transport):
    """Shard endpoints in this process behind mailbox queues.

    ``request`` enqueues the message, drains the shard's mailbox and
    returns the reply — synchronous and deterministic, but through the
    exact message surface the multiprocess backend uses, so everything
    above the transport is backend-agnostic.  A per-shard lock makes the
    drain atomic under concurrent clients (PSClient's threads).
    """

    name = "inproc"

    def __init__(self, *, retry: RetryPolicy | None = None,
                 retry_seed: int = 0):
        super().__init__(retry=retry, retry_seed=retry_seed)
        self._servers: dict[int, ShardServer] = {}
        self._locks: dict[int, threading.RLock] = {}
        self._mail: dict[int, deque] = {}

    def add_shard(self, shard_id, *, dim, optimizer="none", hyper=None):
        if shard_id in self._servers:
            raise ValueError(f"shard {shard_id} already exists")
        self._servers[shard_id] = ShardServer(
            shard_id, dim, optimizer=optimizer, hyper=hyper)
        self._locks[shard_id] = threading.RLock()
        self._mail[shard_id] = deque()

    def _shard_lock(self, shard_id):
        lock = self._locks.get(shard_id)
        return lock if lock is not None else contextlib.nullcontext()

    def _attempt(self, shard_id, msg):
        try:
            server = self._servers[shard_id]
        except KeyError:
            raise PSShardLost(f"shard {shard_id} is not live")
        mail = self._mail[shard_id]
        mail.append(msg)
        reply = None
        while mail:                      # drain the mailbox in order
            reply = server.safe_handle(mail.popleft())
        return _check(reply, shard_id)

    def stop_shard(self, shard_id):
        self.request(shard_id, {"op": "shutdown"})
        self._drop(shard_id)

    def kill_shard(self, shard_id):
        # hard failure: state vanishes with no flush, exactly like a
        # terminated process
        if shard_id not in self._servers:
            raise PSShardLost(f"shard {shard_id} is not live")
        self._drop(shard_id)

    def _mark_lost(self, shard_id):
        self._drop(shard_id)

    def _drop(self, shard_id):
        self._servers.pop(shard_id, None)
        self._locks.pop(shard_id, None)
        self._mail.pop(shard_id, None)

    @property
    def live_shards(self):
        return set(self._servers)


class _Remote:
    __slots__ = ("conn", "proc", "lock")

    def __init__(self, conn, proc):
        self.conn = conn
        self.proc = proc
        self.lock = threading.RLock()


class MultiprocTransport(Transport):
    """One OS process per shard, speaking pickled messages over a duplex
    ``multiprocessing`` connection.

    ``start_method="spawn"`` (default) gives clean numpy-only children —
    :mod:`repro_torch.ps.server` never imports torch, and the lazy
    ``__init__`` of ``repro_torch`` and ``repro_torch.ps`` keeps the import
    graph shallow, so worker startup is
    fast.  ``request_timeout`` bounds every recv *attempt*: a worker
    that misses the deadline but is still alive surfaces as
    :class:`PSShardSlow` (hung ≠ dead) and is retried per
    ``RetryPolicy``; a closed pipe or exited process surfaces as
    :class:`PSShardLost` immediately, with the op name, elapsed time
    and worker exit code in the message.

    ``heartbeat_s`` (default 1.0; ``None`` disables) runs a background
    thread that polls worker liveness, so a crashed shard is detected
    within the heartbeat deadline — not on the next pull/push — and
    reported through ``on_shard_lost``.  ``hedge_s`` (or
    ``retry.hedge_s``) arms hedged resends for idempotent ops.
    """

    name = "multiproc"

    def __init__(self, *, start_method: str = "spawn",
                 request_timeout: float = 60.0,
                 retry: RetryPolicy | None = None, retry_seed: int = 0,
                 heartbeat_s: float | None = 1.0,
                 hedge_s: float | None = None):
        import multiprocessing as mp

        if retry is None:
            retry = RetryPolicy(hedge_s=hedge_s)
        elif hedge_s is not None:
            retry = dataclasses.replace(retry, hedge_s=hedge_s)
        super().__init__(retry=retry, retry_seed=retry_seed)
        self._ctx = mp.get_context(start_method)
        self._timeout = float(request_timeout)
        self._shards: dict[int, _Remote] = {}
        self._hb_stop = threading.Event()
        self._hb_thread: threading.Thread | None = None
        self.heartbeat_s = heartbeat_s
        if heartbeat_s:
            self._hb_thread = threading.Thread(
                target=self._heartbeat_loop, args=(float(heartbeat_s),),
                daemon=True, name="ps-heartbeat")
            self._hb_thread.start()

    def add_shard(self, shard_id, *, dim, optimizer="none", hyper=None):
        if shard_id in self._shards:
            raise ValueError(f"shard {shard_id} already exists")
        parent, child = self._ctx.Pipe(duplex=True)
        proc = self._ctx.Process(
            target=shard_main, args=(child, shard_id, dim, optimizer, hyper),
            daemon=True, name=f"ps-shard-{shard_id}")
        proc.start()
        child.close()
        self._shards[shard_id] = _Remote(parent, proc)

    # --- failure detector ------------------------------------------------
    def _heartbeat_loop(self, interval: float) -> None:
        """Poll worker liveness; a dead process is reaped and reported
        through ``on_shard_lost`` within ~``interval`` of its death.
        ``kill_shard``/``stop_shard`` remove the shard from the map
        first, so intentional removals never fire the callback."""
        while not self._hb_stop.wait(interval):
            for sid, r in list(self._shards.items()):
                if r.proc.is_alive():
                    continue
                # re-check under the shard lock: a racing request may
                # have reaped (or be mid-roundtrip with) this shard
                with r.lock:
                    if self._shards.get(sid) is not r or r.proc.is_alive():
                        continue
                    code = r.proc.exitcode
                    self._reap(sid)
                self._bump("heartbeat_misses", sid, f"exitcode={code}")
                cb = self.on_shard_lost
                if cb is not None:
                    try:
                        cb(sid)
                    except Exception:
                        # the detector must survive a failing handler;
                        # the caller sees the loss on next touch anyway
                        pass

    # --- RPC -------------------------------------------------------------
    def _remote(self, shard_id) -> _Remote:
        try:
            return self._shards[shard_id]
        except KeyError:
            raise PSShardLost(f"shard {shard_id} is not live")

    def _shard_lock(self, shard_id):
        r = self._shards.get(shard_id)
        return r.lock if r is not None else contextlib.nullcontext()

    def _mark_lost(self, shard_id):
        self._reap(shard_id)

    def _send(self, r: _Remote, shard_id: int, msg: dict) -> None:
        try:
            r.conn.send(msg)
        except (BrokenPipeError, OSError):
            code = r.proc.exitcode
            self._reap(shard_id)
            raise PSShardLost(
                f"shard {shard_id} pipe closed on send "
                f"(op={msg.get('op')!r}, exitcode={code})")

    def _attempt(self, shard_id, msg):
        r = self._remote(shard_id)
        self._send(r, shard_id, msg)
        return self._recv(r, shard_id, msg)

    def _recv(self, r: _Remote, shard_id: int, msg: dict) -> dict:
        """Receive the reply to ``msg``, discarding stale-seq replies.

        Hung-vs-dead split: a poll deadline with the worker still alive
        raises :class:`PSShardSlow` (no reap — the worker may answer the
        retried request); EOF / closed pipe / exited process raises
        :class:`PSShardLost` with op, elapsed and exit code, after
        reaping.  If ``retry.hedge_s`` is set and ``msg`` is idempotent,
        a duplicate request is sent once after that long with no reply —
        same seq, so whichever reply lands first wins.
        """
        op, seq = msg.get("op"), msg.get("seq")
        t0 = time.monotonic()
        deadline = t0 + self._timeout
        hedge_at = (t0 + self.retry.hedge_s
                    if self.retry.hedge_s is not None
                    and op in IDEMPOTENT_OPS else None)
        while True:
            now = time.monotonic()
            wait = min(0.25, max(0.0, deadline - now))
            if hedge_at is not None:
                wait = min(wait, max(0.0, hedge_at - now))
            try:
                if r.conn.poll(wait):
                    reply = r.conn.recv()
                    if seq is not None and reply.get("seq", seq) != seq:
                        # a previous attempt's late reply (or a dup) —
                        # drop it and keep waiting for ours
                        self._bump("stale_replies", shard_id)
                        continue
                    return _check(reply, shard_id)
            except (EOFError, OSError):
                code = r.proc.exitcode
                self._reap(shard_id)
                raise PSShardLost(
                    f"shard {shard_id} died mid-request (op={op!r}, "
                    f"elapsed={time.monotonic() - t0:.3f}s, "
                    f"exitcode={code})")
            if not r.proc.is_alive():
                code = r.proc.exitcode
                self._reap(shard_id)
                raise PSShardLost(
                    f"shard {shard_id} process exited (op={op!r}, "
                    f"elapsed={time.monotonic() - t0:.3f}s, "
                    f"exitcode={code})")
            now = time.monotonic()
            if hedge_at is not None and now >= hedge_at:
                # hedged read: race a duplicate of the same request —
                # the seq cache makes the duplicate free server-side
                hedge_at = None
                self._bump("hedges", shard_id, f"op={op}")
                self._send(r, shard_id, msg)
                continue
            if now > deadline:
                # hung, NOT dead: the process is alive but silent — let
                # the retry loop decide (escalation reaps)
                raise PSShardSlow(
                    f"shard {shard_id} no reply (op={op!r}, "
                    f"elapsed={now - t0:.3f}s, timeout={self._timeout}s, "
                    f"process alive)")

    def request_many(self, pairs):
        """Send to every shard first, then collect — distinct shards
        serve concurrently, so an N-shard op costs ~one RPC, not N.

        Honors the base-class partial-failure contract: a dead shard is
        noted, every live shard's reply is still collected, then one
        :class:`PSShardLost` with ``shard_ids`` is raised.  A *slow*
        shard falls back to the per-shard retry loop (resend + backoff,
        seq-deduped server-side) before being declared lost.
        """
        # lock per shard in sorted order (deadlock-free under concurrent
        # request_many calls), keeping each shard's send→recv FIFO intact
        order = sorted({s for s, _ in pairs})
        lost: set[int] = set()
        remotes = {}
        for s in order:
            try:
                remotes[s] = self._remote(s)
            except PSShardLost:
                lost.add(s)
        for s in order:
            if s in remotes:
                remotes[s].lock.acquire()
        try:
            seqd = []
            for s, m in pairs:
                m = dict(m)
                m.setdefault("seq", next(self._seq))
                seqd.append((s, m))
                if s in lost:
                    continue
                try:
                    self._send(remotes[s], s, m)
                except PSShardLost:
                    lost.add(s)
            replies = []
            for s, m in seqd:
                if s in lost:
                    replies.append(None)
                    continue
                try:
                    replies.append(self._recv(remotes[s], s, m))
                except PSShardSlow:
                    # retry continuation: resend/backoff under the lock
                    # we already hold (counts the overlapped first try
                    # as attempt zero)
                    try:
                        replies.append(self._request_locked(s, m))
                    except PSShardLost:
                        lost.add(s)
                        replies.append(None)
                except PSShardLost:
                    lost.add(s)
                    replies.append(None)
        finally:
            for s in reversed(order):
                if s in remotes:
                    remotes[s].lock.release()
        if lost:
            _raise_lost(lost)
        return replies

    # --- lifecycle -------------------------------------------------------
    def _reap(self, shard_id) -> None:
        r = self._shards.pop(shard_id, None)
        if r is None:
            return
        try:
            r.conn.close()
        except OSError:
            pass
        if r.proc.is_alive():
            r.proc.terminate()
        r.proc.join(timeout=1.0)
        if r.proc.is_alive():
            # SIGTERM stays pending on a stopped (SIGSTOP) process —
            # SIGKILL does not
            r.proc.kill()
            r.proc.join(timeout=5.0)

    def stop_shard(self, shard_id):
        r = self._remote(shard_id)
        with r.lock:
            try:
                self.request(shard_id, {"op": "shutdown"})
            except PSShardLost:
                pass                 # raced its own clean exit — fine
            self._reap(shard_id)

    def kill_shard(self, shard_id):
        """Fault injection: SIGTERM the worker, no flush, no goodbye."""
        r = self._remote(shard_id)
        with r.lock:
            self._reap(shard_id)

    @property
    def live_shards(self):
        return set(self._shards)

    def close(self) -> None:
        self._hb_stop.set()
        if self._hb_thread is not None:
            self._hb_thread.join(timeout=5.0)
            self._hb_thread = None
        super().close()


def make_transport(kind: str | Transport | None, **kw) -> Transport:
    """``"inproc"`` | ``"multiproc"`` | an existing instance | None
    (→ in-proc).  The string form is what CLI flags pass through."""
    if kind is None:
        return InProcTransport(**kw)
    if isinstance(kind, Transport):
        return kind
    if kind == "inproc":
        return InProcTransport(**kw)
    if kind == "multiproc":
        return MultiprocTransport(**kw)
    raise ValueError(f"unknown transport {kind!r} "
                     f"(expected inproc|multiproc)")
