"""Deterministic fault injection over the PS transport seam (copy of
``repro.ps.faults``).

Chaos engineering for the parameter server: :class:`FaultInjector` wraps
any :class:`~repro_torch.ps.transport.Transport` (a decorator over the
transport seam) and perturbs the request stream according to a declarative,
seed-driven schedule of :class:`FaultRule`\\ s — the failure oracle the
chaos tests and ``chip_smoke.py`` replay.  Because the rules
and the RNG are seeded, a chaos run is *reproducible*: the same schedule
against the same workload injects the same faults at the same requests.

Fault kinds (one rule each):

==============  ========================================================
kind            effect at the wrapped transport's ``_attempt``
==============  ========================================================
``delay``       sleep ``delay_s`` before forwarding (slow network/shard)
``drop_reply``  forward the request (the shard **applies** it), discard
                the reply, surface a retryable timeout — exercises the
                server's seq-dedup: the retry must not double-apply
``dup_reply``   forward, but hand back a stale-seq duplicate first and
                stash the real reply for the retry — exercises the
                client's stale-reply discard
``recv_error``  transient failure *before* the request is sent (conn
                reset) — the retry's resend is the first delivery
``crash``       kill the worker via ``inner.kill_shard`` and raise
                :class:`~repro_torch.ps.transport.PSShardLost` — replica
                promotion (or checkpoint restore) takes it from there
==============  ========================================================

Everything except ``crash`` is *masked* by the transport retry layer:
training under such a schedule must produce a bit-exact loss trajectory
vs a fault-free run (pinned in tests/test_torch_chaos.py).  ``crash`` is the
real thing — recovery, not retry, territory.

The injector is itself a :class:`Transport`, so it composes: the
fleet's retry loop sits on top (the injector *is* the outermost
``request``), per-shard locking and loss bookkeeping delegate to the
wrapped backend, and the seq counter is **shared** with the inner
transport so cached replies can never collide.
"""

from __future__ import annotations

import dataclasses
import random
import time

from repro_torch.obs import trace as obs_trace
from repro_torch.ps.transport import PSShardLost, PSShardSlow, Transport

KINDS = ("delay", "drop_reply", "dup_reply", "recv_error", "crash")


@dataclasses.dataclass
class FaultRule:
    """One line of a fault schedule.

    Matching: a rule fires when the request's op matches ``op`` (None =
    any), the target shard matches ``shard`` (None = any), the global
    attempt index is in ``[after, until)``, fewer than ``times`` fires
    have happened (None = unlimited), and a seeded coin lands under
    ``prob``.  ``delay_s`` only applies to ``kind="delay"``.
    """

    kind: str
    op: str | None = None
    shard: int | None = None
    prob: float = 1.0
    after: int = 0
    until: int | None = None
    times: int | None = None
    delay_s: float = 0.0
    fired: int = 0

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r} "
                             f"(expected one of {KINDS})")

    def matches(self, n: int, op: str | None, shard: int) -> bool:
        if self.op is not None and op != self.op:
            return False
        if self.shard is not None and shard != self.shard:
            return False
        if n < self.after or (self.until is not None and n >= self.until):
            return False
        if self.times is not None and self.fired >= self.times:
            return False
        return True


def parse_schedule(spec) -> list[FaultRule]:
    """Build a fault schedule from rules, dicts, or a compact string.

    Accepts a list of :class:`FaultRule`/dicts, or a string of
    ``;``-separated rules, each ``key=value`` pairs joined by ``,`` —
    the CLI surface::

        "crash,op=grad,shard=1,after=50,times=1;delay,delay_s=0.01,prob=0.2"

    (a bare first token is the ``kind``).
    """
    if spec is None:
        return []
    if isinstance(spec, str):
        rules = []
        for part in filter(None, (p.strip() for p in spec.split(";"))):
            kw: dict = {}
            for i, tok in enumerate(t.strip() for t in part.split(",")):
                if "=" not in tok:
                    if i != 0:
                        raise ValueError(f"bad fault token {tok!r} in "
                                         f"{part!r}")
                    kw["kind"] = tok
                    continue
                k, v = tok.split("=", 1)
                if k in ("shard", "after", "until", "times"):
                    kw[k] = int(v)
                elif k in ("prob", "delay_s"):
                    kw[k] = float(v)
                else:
                    kw[k] = v
            rules.append(FaultRule(**kw))
        return rules
    out = []
    for r in spec:
        out.append(r if isinstance(r, FaultRule) else FaultRule(**dict(r)))
    return out


class FaultInjector(Transport):
    """Transport decorator injecting faults from a seeded schedule.

    All lifecycle and bookkeeping (locks, loss reaping, heartbeat
    callback, live-shard set) delegate to ``inner``; only the
    send/recv attempt is perturbed.  ``injections`` records every fired
    fault (``{"n", "kind", "op", "shard"}``) for assertions, and each
    fire lands as a ``ps.fault.<kind>`` obs instant when tracing.
    """

    def __init__(self, inner: Transport, schedule=None, *, seed: int = 0):
        self.inner = inner
        super().__init__(retry=inner.retry)
        self.name = f"faults({inner.name})"
        self._seq = inner._seq          # shared: seqs must never collide
        self.rules = parse_schedule(schedule)
        self._rng = random.Random(seed)
        self._n = 0                     # global attempt index
        #: (shard, seq) → real reply stashed by a dup_reply fire
        self._stash: dict[tuple[int, int | None], dict] = {}
        self.injections: list[dict] = []

    # --- schedule --------------------------------------------------------
    def _fire(self, rule: FaultRule, n: int, op, shard_id: int) -> None:
        rule.fired += 1
        self.injections.append(
            {"n": n, "kind": rule.kind, "op": op, "shard": shard_id})
        if obs_trace.enabled():
            obs_trace.instant(f"ps.fault.{rule.kind}", "ps", n=n, op=op,
                              shard=shard_id)

    def _attempt(self, shard_id: int, msg: dict) -> dict:
        key = (shard_id, msg.get("seq"))
        stashed = self._stash.pop(key, None)
        if stashed is not None:
            # the retry after a dup_reply fire: the "real" reply that was
            # in flight behind the duplicate arrives now
            return stashed
        self._n += 1
        n, op = self._n, msg.get("op")
        structural: FaultRule | None = None
        for rule in self.rules:
            if not rule.matches(n, op, shard_id):
                continue
            if rule.prob < 1.0 and self._rng.random() >= rule.prob:
                continue
            if rule.kind == "delay":
                self._fire(rule, n, op, shard_id)
                time.sleep(rule.delay_s)
            elif structural is None:    # first structural fault wins
                structural = rule
        if structural is None:
            return self.inner._attempt(shard_id, msg)
        self._fire(structural, n, op, shard_id)
        kind = structural.kind
        if kind == "recv_error":
            # never reached the shard — the retry's resend is delivery #1
            raise PSShardSlow(
                f"fault-injected recv error (op={op!r}, shard={shard_id})")
        if kind == "crash":
            try:
                self.inner.kill_shard(shard_id)
            except PSShardLost:
                pass                    # already gone — still report lost
            err = PSShardLost(
                f"fault-injected crash of shard {shard_id} (op={op!r})")
            err.shard_ids = {shard_id}
            raise err
        reply = self.inner._attempt(shard_id, msg)
        if kind == "drop_reply":
            # the shard applied the request; the reply evaporates — the
            # retry must be answered from the server's seq cache
            raise PSShardSlow(
                f"fault-injected dropped reply (op={op!r}, "
                f"shard={shard_id})")
        # dup_reply: a stale-seq duplicate arrives first; the real reply
        # waits in the stash for the retry
        self._stash[key] = reply
        stale = dict(reply)
        stale["seq"] = -1
        return stale

    # --- delegation ------------------------------------------------------
    def _shard_lock(self, shard_id):
        return self.inner._shard_lock(shard_id)

    def _mark_lost(self, shard_id):
        self.inner._mark_lost(shard_id)

    @property
    def on_shard_lost(self):
        return self.inner.on_shard_lost

    @on_shard_lost.setter
    def on_shard_lost(self, fn):
        self.inner.on_shard_lost = fn

    def add_shard(self, shard_id, *, dim, optimizer="none", hyper=None):
        self.inner.add_shard(shard_id, dim=dim, optimizer=optimizer,
                             hyper=hyper)

    def stop_shard(self, shard_id):
        self.inner.stop_shard(shard_id)

    def kill_shard(self, shard_id):
        self.inner.kill_shard(shard_id)

    @property
    def live_shards(self):
        return self.inner.live_shards

    def collect_obs(self):
        return self.inner.collect_obs()

    def close(self):
        self.inner.close()
