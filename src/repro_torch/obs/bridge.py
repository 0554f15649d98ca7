"""Live-metrics → cost-model bridge (the reactive re-planner's seam; the
port's copy of ``repro.obs.bridge``).

HeterPS schedules against *analytic* ``ResourceType``/``LayerProfile``
constants computed once, offline (``core/resources.py`` /
``core/profiles.py``).  This module turns the obs spine's **measured**
signals into those exact shapes, so the re-planner (``core/replan.py``)
can hand the fused RL search live profiles instead of nominal ones:

* :func:`snapshot_resources` — one coherent snapshot: a ``ResourceType``
  whose bandwidth terms are re-anchored to measured PS traffic (the same
  arithmetic as :meth:`repro_torch.ps.telemetry.PSTelemetry.to_resource`, read
  from the metric registries), measured embedding-layer ODT seconds, and
  the serve-side SLO signals (queue depth, page-pool occupancy, TTFT /
  TPOT percentiles) the admission policy would tune against;
* :func:`apply_measured_odt` — graft measured ``(sync, act)`` seconds
  onto a ``LayerProfile``, index-aligned with the fleet, exactly what
  ``core/cost_model.py`` consumes.
"""

from __future__ import annotations

import dataclasses

from repro_torch.core.profiles import LayerProfile
from repro_torch.core.resources import ResourceType
from repro_torch.obs import metrics as obs_metrics


def _ps_traffic(registries=None) -> dict:
    """Aggregate PS pull/push traffic over every live registry carrying
    ``PSTelemetry``-named counters (``ps.bytes``/``ps.seconds`` labeled
    ``dir=pull|push``, one shard per label) — per-registry ``seconds`` is
    the max over shards (shards serve concurrently), matching
    ``PSTelemetry.totals``; registries (independent tables) add up.

    Closed registries are skipped: every ``PSTelemetry`` owns a fresh
    named registry that outlives its table in ``all_registries()``, so
    without the filter a snapshot taken after e.g. ``bench_ps``'s sync
    run would sum dead clients' cumulative traffic into the *live*
    bandwidths the re-planner consumes."""
    out = {d: {"bytes": 0.0, "seconds": 0.0, "rows": 0.0}
           for d in ("pull", "push")}
    for reg in (registries if registries is not None
                else obs_metrics.live_registries()):
        if reg.closed:
            continue
        for d in ("pull", "push"):
            per_shard_secs = [m.value for lab, m in reg.find("ps.seconds")
                              if lab.get("dir") == d]
            if not per_shard_secs:
                continue
            out[d]["seconds"] += max(per_shard_secs)
            out[d]["bytes"] += sum(m.value for lab, m in reg.find("ps.bytes")
                                   if lab.get("dir") == d)
            out[d]["rows"] += sum(m.value for lab, m in reg.find("ps.rows")
                                  if lab.get("dir") == d)
    return out


def _serve_signals(registry=None) -> dict:
    reg = registry if registry is not None else obs_metrics.REGISTRY
    sig: dict = {
        "queue_depth": reg.value("serve.queue_depth"),
        "pool_pages_used": reg.value("serve.pool_pages_used"),
        "pool_pages_total": reg.value("serve.pool_pages_total"),
        "evictions": reg.value("serve.evictions"),
        "admissions": reg.value("serve.admissions"),
        "tokens": reg.value("serve.tokens"),
        # overload-robustness outcome counters — the admission
        # actuator's breach/health inputs
        "completed": reg.value("serve.completed"),
        "rejected": reg.value("serve.rejected"),
        "timed_out": reg.value("serve.timed_out"),
        "preemptions": reg.value("serve.preemptions"),
        "resumes": reg.value("serve.resumes"),
        "good_tokens": reg.value("serve.good_tokens"),
        "stalls": reg.value("serve.stalls"),
    }
    for name, key in (("serve.ttft_s", "ttft"), ("serve.tpot_s", "tpot"),
                      ("serve.deadline_slack_s", "deadline_slack")):
        hists = [h for _, h in reg.find(name)]
        if not hists:
            continue
        # find() may match several labeled histograms under one name —
        # merge them into one pooled snapshot (bucket counts add, the
        # GROWTH quantile bound holds against the union) instead of
        # silently keeping whichever iterated last
        sig[key] = (hists[0].snapshot() if len(hists) == 1
                    else obs_metrics.merge_histograms(hists))
        sig[key]["streams"] = len(hists)
    return sig


def fleet_health(fleet) -> dict:
    """Degradation signals of an elastic PS fleet — the failure-domain
    inputs a reactive re-planner needs alongside bandwidths: live vs
    referenced shards, buckets currently missing a replica, in-flight
    migrations, and the transport's retry/hedge/heartbeat counters
    (escalations = shards declared dead).

    Duck-typed: ``fleet`` is any object with the reference
    ``ElasticPSFleet``'s attributes (``_mu``, ``transport``, ``primary``,
    ``backup``, ``replicas``, ``_migrations``, ``events``); nothing of an
    elastic fleet is imported here."""
    import numpy as np

    with fleet._mu:
        live = set(fleet.transport.live_shards)
        referenced = {int(s) for s in set(fleet.primary) | set(fleet.backup)
                      if s >= 0}
        unreplicated = (int(np.count_nonzero(fleet.backup < 0))
                        if fleet.replicas else 0)
        health = {
            "live_shards": sorted(live),
            "dead_shards": sorted(referenced - live),
            "buckets_unreplicated": unreplicated,
            "migrating": len(fleet._migrations),
            "transport": dict(fleet.transport.counters),
            "events": {
                k: sum(1 for e in fleet.events if e["kind"] == k)
                for k in ("kill", "recover", "detected", "restore")},
        }
    inner = getattr(fleet.transport, "inner", None)
    if inner is not None:            # FaultInjector: fold backend counters
        for k, v in inner.counters.items():
            health["transport"][k] = health["transport"].get(k, 0) + v
    health["degraded"] = bool(health["dead_shards"]
                              or health["buckets_unreplicated"])
    return health


def snapshot_resources(base: ResourceType, *, telemetry=None,
                       num_examples: int | None = None,
                       registry=None, fleet=None) -> dict:
    """Turn live metrics into the shapes ``core/profiles.py`` consumes.

    Returns ``{"resource": ResourceType, "embedding_odt": (sync, act),
    "serve": {...}, "ps": {...}}`` — plus ``"ps_health"`` when ``fleet``
    (an elastic PS fleet, see :func:`fleet_health`) is given, so a
    re-planner sees degraded shards, not just bandwidths.  ``telemetry``
    (a ``PSTelemetry``) takes precedence for the PS side; otherwise the
    traffic is read from the metric registries.  Bandwidth terms with no traffic keep the
    ``base`` constants — a cold snapshot degrades to the analytic model.
    """
    if telemetry is not None:
        res = telemetry.to_resource(base)
        odt = (telemetry.embedding_odt(num_examples)
               if num_examples else (0.0, 0.0))
        t = telemetry.totals()
        ps = {d: {k: t[d][k] for k in ("bytes", "seconds", "rows")}
              for d in ("pull", "push")}
    else:
        ps = _ps_traffic()
        pull_s, push_s = ps["pull"]["seconds"], ps["push"]["seconds"]
        ingest = ps["pull"]["bytes"] / pull_s if pull_s > 0 else 0.0
        net_b = ps["pull"]["bytes"] + ps["push"]["bytes"]
        net_s = pull_s + push_s
        net = net_b / net_s if net_s > 0 else 0.0
        res = dataclasses.replace(
            base, name=base.name + "+obs",
            ingest_bw=ingest if ingest > 0 else base.ingest_bw,
            net_bw=net if net > 0 else base.net_bw)
        if num_examples:
            from repro_torch.core.profiles import B_O

            per_ex = net_s / num_examples
            act_per_ex = pull_s / num_examples
            odt = (per_ex * B_O, act_per_ex * B_O)
        else:
            odt = (0.0, 0.0)
    out = {"resource": res, "embedding_odt": odt,
           "serve": _serve_signals(registry), "ps": ps}
    if fleet is not None:
        out["ps_health"] = fleet_health(fleet)
    return out


@dataclasses.dataclass(frozen=True)
class SnapshotDelta:
    """Interval rates between two :func:`snapshot_resources` snapshots.

    The metric registries are **cumulative since process start**, so a
    re-planner that read two snapshots and divided lifetime bytes by
    lifetime seconds would see a *lifetime average* — a mid-run bandwidth
    collapse gets diluted toward invisibility as the run ages.  This is
    the windowed view: every byte/second/count field is the difference
    ``cur − prev``, and the bandwidth properties are Δbytes/Δseconds over
    the window only.  Gauges (queue depth, pool occupancy) are sampled at
    the window end plus a growth term; histograms stay lifetime (their
    buckets are not exposed in snapshots) but ride along with the count
    of requests that *completed inside the window*, so SLO checks can be
    gated on the window actually having seen traffic.
    """

    seconds: float               #: wall-clock span of the window
    pull_bytes: float
    push_bytes: float
    pull_seconds: float          #: PS in-flight seconds within the window
    push_seconds: float
    tokens: float                #: serve tokens emitted in the window
    queue_depth: float           #: depth at window end (gauge)
    queue_growth: float          #: depth end − depth start
    ttft: dict | None            #: lifetime TTFT snapshot at window end
    tpot: dict | None
    ttft_completed: float        #: requests whose TTFT landed in-window
    tpot_completed: float
    ps_degraded: bool            #: fleet health at window end
    dead_shards: int
    fleet_events: int            #: lifecycle events (join/leave/kill/
    #: detected/recover/restore) that fired inside the window
    # overload-robustness outcome deltas — defaulted so snapshots
    # taken before the serve loop ran (or by older callers) still diff
    completed: float = 0.0       #: requests completed in the window
    rejected: float = 0.0       #: admission rejections in the window
    timed_out: float = 0.0       #: deadline timeouts in the window
    preempted: float = 0.0       #: slot preemptions in the window
    resumed: float = 0.0        #: preempted requests resumed in-window
    good_tokens: float = 0.0     #: deadline-met tokens in the window

    @property
    def goodput_tok_per_s(self) -> float:
        """Windowed deadline-met tokens per second (0.0 = none)."""
        return self.good_tokens / self.seconds if self.seconds > 0 else 0.0

    @property
    def ingest_bw(self) -> float:
        """Windowed pull bandwidth (0.0 = no pull traffic this window)."""
        return (self.pull_bytes / self.pull_seconds
                if self.pull_seconds > 0 else 0.0)

    @property
    def net_bw(self) -> float:
        """Windowed pull+push bandwidth (0.0 = no traffic this window)."""
        b = self.pull_bytes + self.push_bytes
        s = self.pull_seconds + self.push_seconds
        return b / s if s > 0 else 0.0

    @property
    def has_ps_traffic(self) -> bool:
        return (self.pull_seconds + self.push_seconds) > 0.0

    def resource(self, base: ResourceType) -> ResourceType:
        """``base`` re-anchored to this window's measured bandwidths
        (terms without window traffic keep the ``base`` constants)."""
        ingest, net = self.ingest_bw, self.net_bw
        return dataclasses.replace(
            base, name=base.name + "+win",
            ingest_bw=ingest if ingest > 0 else base.ingest_bw,
            net_bw=net if net > 0 else base.net_bw)

    def embedding_odt(self, num_examples: float) -> tuple[float, float]:
        """Windowed measured ``(odt_sync, odt_act)`` seconds per ``B_O``
        profiling window, from this window's PS traffic over
        ``num_examples`` training examples processed in the window."""
        from repro_torch.core.profiles import B_O

        if num_examples <= 0 or not self.has_ps_traffic:
            return 0.0, 0.0
        per_ex = (self.pull_seconds + self.push_seconds) / num_examples
        act_per_ex = self.pull_seconds / num_examples
        return per_ex * B_O, act_per_ex * B_O


def _hist_count(sig: dict, key: str) -> float:
    h = sig.get(key)
    return float(h["count"]) if h else 0.0


def snapshot_delta(prev: dict, cur: dict, seconds: float) -> SnapshotDelta:
    """The windowed difference of two :func:`snapshot_resources` dicts
    (``prev`` taken ``seconds`` before ``cur``)."""
    pp, cp = prev["ps"], cur["ps"]
    ps_, cs = prev["serve"], cur["serve"]
    health = cur.get("ps_health")
    ev_prev = sum(prev["ps_health"]["events"].values()) \
        if prev.get("ps_health") else 0
    ev_cur = sum(health["events"].values()) if health else 0
    return SnapshotDelta(
        seconds=float(seconds),
        pull_bytes=cp["pull"]["bytes"] - pp["pull"]["bytes"],
        push_bytes=cp["push"]["bytes"] - pp["push"]["bytes"],
        pull_seconds=cp["pull"]["seconds"] - pp["pull"]["seconds"],
        push_seconds=cp["push"]["seconds"] - pp["push"]["seconds"],
        tokens=cs["tokens"] - ps_["tokens"],
        queue_depth=cs["queue_depth"],
        queue_growth=cs["queue_depth"] - ps_["queue_depth"],
        ttft=cs.get("ttft"),
        tpot=cs.get("tpot"),
        ttft_completed=_hist_count(cs, "ttft") - _hist_count(ps_, "ttft"),
        tpot_completed=_hist_count(cs, "tpot") - _hist_count(ps_, "tpot"),
        ps_degraded=bool(health["degraded"]) if health else False,
        dead_shards=len(health["dead_shards"]) if health else 0,
        fleet_events=ev_cur - ev_prev,
        # .get(): hand-built snapshot dicts may lack these
        completed=cs.get("completed", 0.0) - ps_.get("completed", 0.0),
        rejected=cs.get("rejected", 0.0) - ps_.get("rejected", 0.0),
        timed_out=cs.get("timed_out", 0.0) - ps_.get("timed_out", 0.0),
        preempted=cs.get("preemptions", 0.0) - ps_.get("preemptions", 0.0),
        resumed=cs.get("resumes", 0.0) - ps_.get("resumes", 0.0),
        good_tokens=cs.get("good_tokens", 0.0) - ps_.get("good_tokens", 0.0),
    )


def apply_measured_odt(profile: LayerProfile, sync: float,
                       act: float) -> LayerProfile:
    """``profile`` with its per-type ODT terms replaced by one measured
    ``(sync, act)`` pair, broadcast across the fleet's resource types —
    the drop-in the scheduler's cost model consumes."""
    n = len(profile.oct)
    return dataclasses.replace(
        profile, odt_sync=(float(sync),) * n, odt_act=(float(act),) * n)
