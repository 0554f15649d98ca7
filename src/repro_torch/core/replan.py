"""Reactive re-planning: the telemetry→scheduler feedback loop (the
port's copy of ``repro.core.replan``).

HeterPS plans once, offline, against analytic profiles — but the fleet
the plan runs on drifts: a PS shard dies, ingest bandwidth collapses,
serve SLOs blow out.  This module closes the circle the obs spine
opened: :class:`ReplanController` windows successive
:func:`repro_torch.obs.bridge.snapshot_resources` snapshots into
**interval** rates (:func:`repro_torch.obs.bridge.snapshot_delta` — the
registries are
cumulative, so lifetime averages would dilute any mid-run drift),
detects drift against the assumptions the incumbent plan was made
under, and when triggered re-runs the fused RL search
(``scheduler.schedule_many`` with the incumbent as a warm-start anchor)
over profiles **rebuilt from the live fleet** — ``LayerProfile`` bakes
bandwidths in at build time, so measurements only reach the cost model
through :func:`repro_torch.core.profiles.profile_layers` on a
re-anchored ``ResourceType`` plus
:func:`repro_torch.obs.bridge.apply_measured_odt` on
the sparse layers.

Stability is structural, not tuned:

* **warm start** — the incumbent is an oracle-scored anchor inside the
  search's cost cache, so the candidate is never worse than the plan it
  might replace (under the live profiles both are scored on);
* **switch margin** — the candidate is applied only if its predicted
  cost beats the incumbent's live-profile cost by more than
  ``switch_margin`` (re-planning has a real cost: weight migration,
  cache warmup);
* **hysteresis** — noisy signals (bandwidth drift, SLO p99, queue
  growth) must persist for ``hysteresis_windows`` consecutive windows;
  discrete fleet events (kill/recover) and a *rising edge* of
  ``ps_health.degraded`` fire immediately — a persistently-degraded
  fleet does not re-fire every window;
* **cooldown** — after any replan consideration (applied or not) the
  detector is re-anchored to the window that triggered it and drift
  checks pause for ``cooldown_windows`` windows, so one sustained shift
  produces exactly one replan, not a flap.

The first completed window is a **calibration**: in-process measured
bandwidths differ from the nominal fleet constants by orders of
magnitude, so the controller re-anchors its assumptions (and, with
``calibrate=True``, re-plans once against measured reality) before any
drift detection — otherwise the very first window would always
"drift".  Calibration is reported separately from drift replans.
"""

from __future__ import annotations

import dataclasses
import math
import threading
import time
import traceback
from typing import Callable, Sequence

from repro_torch.core.cost_model import TrainingJob, plan_cost
from repro_torch.core.plan import SchedulingPlan
from repro_torch.core.profiles import LayerProfile, profile_layers
from repro_torch.core.resources import ResourceType
from repro_torch.obs.bridge import (
    SnapshotDelta,
    apply_measured_odt,
    snapshot_delta,
)

#: layer kinds whose ODT terms come from measured PS traffic
_SPARSE_KINDS = ("embedding", "nce")


@dataclasses.dataclass
class ReplanConfig:
    """Knobs of the reactive loop (defaults favour stability)."""

    #: wall-clock window span for the background loop / time-driven ticks
    window_s: float = 5.0
    #: step-driven mode: complete a window every N ``observe()`` calls
    #: (0 = time-driven via ``window_s``)
    window_steps: int = 0
    #: relative deviation of windowed bandwidth vs the anchored
    #: assumption that counts as drift (0.5 = ±50%)
    bw_tolerance: float = 0.5
    #: windows with less than this much in-flight PS time don't get a
    #: bandwidth verdict (a handful of RPCs is noise, not a rate)
    min_traffic_s: float = 1e-4
    #: serve SLOs — p99 above these (with completions in the window)
    #: counts as drift; 0 disables the check
    ttft_slo_s: float = 0.0
    tpot_slo_s: float = 0.0
    #: queue-depth growth per window that counts as drift; 0 disables
    queue_growth: float = 0.0
    #: consecutive windows a noisy signal must persist before firing
    hysteresis_windows: int = 2
    #: windows to sit out after a replan consideration
    cooldown_windows: int = 3
    #: candidate must beat the incumbent's live cost by this fraction
    switch_margin: float = 0.05
    #: re-plan once on the calibration window (first window with PS
    #: traffic) so the incumbent reflects measured, not nominal, rates
    calibrate: bool = True
    #: minimum window examples before measured ODT is grafted onto the
    #: sparse layers (below this the per-example rates are noise)
    min_examples: int = 1


@dataclasses.dataclass
class Incumbent:
    """The currently-applied plan plus the context it was scored in."""

    assignment: tuple[int, ...]
    cost: float
    profiles: list[LayerProfile]
    fleet: list[ResourceType]

    @property
    def plan(self) -> SchedulingPlan:
        return SchedulingPlan(self.assignment)


class DriftDetector:
    """Classifies one :class:`SnapshotDelta` against anchored assumptions.

    Two signal classes: *edge* signals (fleet lifecycle events, the
    rising edge of ``degraded``) fire on the window they appear in;
    *noisy* signals (bandwidth deviation, SLO p99, queue growth) keep a
    per-reason streak and fire only after ``hysteresis_windows``
    consecutive positive windows.  :meth:`reanchor` resets the bandwidth
    assumptions (and streaks) to a new baseline — called after every
    replan consideration so the same shift cannot re-trigger.
    """

    def __init__(self, config: ReplanConfig, *, ingest_bw: float,
                 net_bw: float):
        self.cfg = config
        self.assumed_ingest = ingest_bw
        self.assumed_net = net_bw
        self._streak: dict[str, int] = {}
        self._was_degraded = False

    def reanchor(self, *, ingest_bw: float | None = None,
                 net_bw: float | None = None) -> None:
        if ingest_bw is not None and ingest_bw > 0:
            self.assumed_ingest = ingest_bw
        if net_bw is not None and net_bw > 0:
            self.assumed_net = net_bw
        self._streak.clear()

    @staticmethod
    def _deviates(measured: float, assumed: float, tol: float) -> bool:
        if measured <= 0 or assumed <= 0:
            return False
        return abs(measured - assumed) / assumed > tol

    def check(self, delta: SnapshotDelta) -> list[str]:
        """Reasons this window counts as drift (empty = steady state)."""
        cfg = self.cfg
        reasons: list[str] = []
        if delta.fleet_events > 0:
            reasons.append("fleet_events")
        if delta.ps_degraded and not self._was_degraded:
            reasons.append("ps_degraded")
        self._was_degraded = delta.ps_degraded

        noisy: list[str] = []
        if (delta.pull_seconds + delta.push_seconds) >= cfg.min_traffic_s:
            if self._deviates(delta.ingest_bw, self.assumed_ingest,
                              cfg.bw_tolerance):
                noisy.append("ingest_bw")
            if self._deviates(delta.net_bw, self.assumed_net,
                              cfg.bw_tolerance):
                noisy.append("net_bw")
        for key, slo in (("ttft", cfg.ttft_slo_s), ("tpot", cfg.tpot_slo_s)):
            snap = getattr(delta, key)
            completed = getattr(delta, f"{key}_completed")
            if slo > 0 and snap and completed > 0 and snap["p99"] > slo:
                noisy.append(f"{key}_slo")
        if cfg.queue_growth > 0 and delta.queue_growth > cfg.queue_growth:
            noisy.append("queue_growth")

        for r in noisy:
            self._streak[r] = self._streak.get(r, 0) + 1
            if self._streak[r] >= cfg.hysteresis_windows:
                reasons.append(r)
        for r in list(self._streak):
            if r not in noisy:
                del self._streak[r]
        return reasons


class AdmissionActuator:
    """AIMD tuning of an :class:`~repro_torch.core.admission.AdmissionPolicy`
    from windowed serve telemetry — the actuation half of the ROADMAP's
    "admission-control policy the scheduler itself tunes".

    Fed one :class:`~repro_torch.obs.bridge.SnapshotDelta` per controller
    window (:meth:`tune`), it classifies the window:

    * **breach** — admitted-request TTFT p99 above ``ttft_slo_s`` (with
      completions in the window, so an idle window can't breach) or any
      in-window deadline timeout.  Response is multiplicative decrease
      of ``queue_bound`` — the primary lever: decode chunks are fixed-
      shape over *all* slots, so TPOT is ~flat in concurrency and
      admitted TTFT is dominated by queued wait, which the queue bound
      caps directly.  After ``concurrency_after`` *consecutive* breach
      windows the queue bound alone is judged insufficient and
      ``max_concurrency`` is also decreased.
    * **healthy** — no breach and the window saw progress (completions
      or deadline-met tokens).  Response is additive increase of both
      knobs back toward their ceilings, reclaiming capacity the next
      burst can use.

    Idle windows (no breach, no progress) leave the knobs alone.  The
    policy's knobs are plain attributes read by the serve loop each
    admission pass, so retuning from the controller thread is a
    single-attribute write — safe under the GIL, effective on the very
    next admission decision.
    """

    def __init__(self, policy, *, ttft_slo_s: float = 0.0,
                 decrease: float = 0.5, increase: int = 1,
                 min_queue_bound: int = 1,
                 max_queue_bound: int | None = None,
                 min_concurrency: int = 1, concurrency_after: int = 2):
        if not 0.0 < decrease < 1.0:
            raise ValueError(f"decrease must be in (0, 1), got {decrease}")
        self.policy = policy
        self.ttft_slo_s = float(ttft_slo_s)
        self.decrease = float(decrease)
        self.increase = int(increase)
        self.min_queue_bound = int(min_queue_bound)
        # an unbounded policy needs a finite ceiling to climb back to
        self.max_queue_bound = (int(max_queue_bound)
                                if max_queue_bound is not None
                                else (policy.queue_bound
                                      if policy.queue_bound is not None
                                      else 8 * policy.slots))
        self.min_concurrency = int(min_concurrency)
        self.concurrency_after = int(concurrency_after)
        self._breach_streak = 0
        self.breaches = 0
        self.decisions: list[dict] = []

    def tune(self, delta) -> dict | None:
        """Apply one window of telemetry; returns the decision applied
        (``None`` for an idle window)."""
        p = self.policy
        ttft_breach = (self.ttft_slo_s > 0.0 and delta.ttft is not None
                       and delta.ttft_completed > 0
                       and delta.ttft["p99"] > self.ttft_slo_s)
        breach = ttft_breach or delta.timed_out > 0
        progressed = delta.completed > 0 or delta.good_tokens > 0
        if not breach and not progressed:
            return None
        qb = p.queue_bound if p.queue_bound is not None \
            else self.max_queue_bound
        mc = p.max_concurrency
        if breach:
            self.breaches += 1
            self._breach_streak += 1
            p.queue_bound = max(self.min_queue_bound,
                                int(qb * self.decrease))
            if self._breach_streak >= self.concurrency_after:
                p.max_concurrency = max(self.min_concurrency,
                                        int(mc * self.decrease))
            action = "decrease"
        else:
            self._breach_streak = 0
            p.queue_bound = min(self.max_queue_bound, qb + self.increase)
            p.max_concurrency = min(p.slots, mc + self.increase)
            action = "increase"
        decision = {
            "action": action,
            "ttft_breach": ttft_breach,
            "timed_out": float(delta.timed_out),
            "queue_bound": (qb, p.queue_bound),
            "max_concurrency": (mc, p.max_concurrency),
            "breach_streak": self._breach_streak,
        }
        self.decisions.append(decision)
        return decision

    def report(self) -> dict:
        return {
            "ttft_slo_s": self.ttft_slo_s,
            "breaches": self.breaches,
            "queue_bound": self.policy.queue_bound,
            "max_concurrency": self.policy.max_concurrency,
            "decisions": list(self.decisions),
        }


class ReplanController:
    """Windows live snapshots, detects drift, re-plans with hysteresis.

    ``layer_specs`` are the raw ``(kind, flops, in_b, w_b, out_b)``
    tuples (``core/profiles.py``) — the controller must rebuild profiles
    per replan because ``LayerProfile`` bakes fleet bandwidths in at
    build time.  ``snapshot_fn`` returns a
    :func:`~repro_torch.obs.bridge.snapshot_resources`-shaped dict; the fleet
    resource at ``base_index`` is the one re-anchored to measured PS
    bandwidths (the CPU/PS side — accelerator constants stay nominal).

    Drive it either way:

    * **step-driven** — call :meth:`observe` once per training step
      (``window_steps > 0`` completes a window every N steps); the
      training loop stays single-threaded and deterministic;
    * **time-driven** — :meth:`start` spawns a daemon thread ticking
      every ``window_s`` seconds (the serve path, where there is no
      step loop to piggyback on).
    """

    def __init__(
        self,
        layer_specs: Sequence[tuple],
        fleet: Sequence[ResourceType],
        job: TrainingJob,
        scheduler,
        *,
        snapshot_fn: Callable[[], dict],
        config: ReplanConfig | None = None,
        base_index: int = 0,
        clock: Callable[[], float] = time.monotonic,
        initial: Sequence[int] | None = None,
        admission: AdmissionActuator | None = None,
    ):
        self.layer_specs = list(layer_specs)
        self.fleet = list(fleet)
        self.job = job
        self.scheduler = scheduler
        self.snapshot_fn = snapshot_fn
        self.cfg = config if config is not None else ReplanConfig()
        self.base_index = base_index
        self.clock = clock
        self.admission = admission

        profiles = profile_layers(self.layer_specs, self.fleet)
        if initial is not None:
            assignment = tuple(int(a) for a in initial)
            cost, _ = plan_cost(SchedulingPlan(assignment), profiles,
                                self.fleet, job)
        else:
            res = self._run_search(profiles, self.fleet, warm=())
            assignment, cost = tuple(res.plan.assignment), res.cost
        self.incumbent = Incumbent(assignment, cost, profiles, self.fleet)

        base = self.fleet[base_index]
        self.detector = DriftDetector(self.cfg, ingest_bw=base.ingest_bw,
                                      net_bw=base.net_bw)

        self._lock = threading.Lock()
        self._prev: dict | None = None
        self._prev_t = 0.0
        self._prev_examples = 0.0
        self._examples = 0.0
        self._steps_since = 0
        self._last_window_t = self.clock()
        self._calibrated = False
        self._cooldown = 0
        self.windows = 0
        self.calibrations = 0
        self.considered = 0
        self.applied = 0
        self.decisions: list[dict] = []
        #: tracebacks of background ticks that raised (reported, not raised)
        self.errors: list[str] = []
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    # --- search plumbing ------------------------------------------------
    def _run_search(self, profiles, fleet, warm):
        """One scheduler invocation, warm-seeded when supported."""
        many = getattr(self.scheduler, "schedule_many", None)
        if many is not None:
            try:
                return many([(profiles, fleet, self.job)],
                            warm_starts=[warm])[0]
            except TypeError:  # scheduler without the warm-start seam
                return many([(profiles, fleet, self.job)])[0]
        return self.scheduler.schedule(profiles, fleet, self.job)

    # --- driving --------------------------------------------------------
    def observe(self, num_examples: float = 0.0,
                snapshot: dict | None = None) -> dict | None:
        """Step-driven entry: account examples, complete a window when
        due (every ``window_steps`` calls, or ``window_s`` seconds when
        ``window_steps == 0``).  Returns the decision dict when a window
        completed with a replan consideration, else ``None``."""
        with self._lock:
            self._examples += num_examples
            self._steps_since += 1
            if self.cfg.window_steps > 0:
                if self._steps_since < self.cfg.window_steps:
                    return None
            elif (self.clock() - self._last_window_t) < self.cfg.window_s:
                return None
            return self._tick_locked(snapshot)

    def tick(self, snapshot: dict | None = None) -> dict | None:
        """Complete a window now (the background loop's entry)."""
        with self._lock:
            return self._tick_locked(snapshot)

    def _tick_locked(self, snapshot: dict | None) -> dict | None:
        snap = snapshot if snapshot is not None else self.snapshot_fn()
        now = self.clock()
        self._steps_since = 0
        self._last_window_t = now
        if self._prev is None:  # first snapshot opens the first window
            self._prev, self._prev_t = snap, now
            self._prev_examples = self._examples
            return None
        delta = snapshot_delta(self._prev, snap, max(now - self._prev_t,
                                                     1e-12))
        window_examples = self._examples - self._prev_examples
        self._prev, self._prev_t = snap, now
        self._prev_examples = self._examples
        self.windows += 1

        if self.admission is not None:
            # admission actuation is per-window and independent of the
            # (hysteresis/cooldown-gated) replan path: overload must be
            # answered on the window it appears in, not two windows later
            self.admission.tune(delta)

        if not self._calibrated:
            if not delta.has_ps_traffic:
                return None  # nothing measured yet; stay uncalibrated
            self._calibrated = True
            self.detector.reanchor(ingest_bw=delta.ingest_bw,
                                   net_bw=delta.net_bw)
            if self.cfg.calibrate:
                return self._replan(delta, window_examples,
                                    kind="calibrate", reasons=["calibrate"])
            return None

        reasons = self.detector.check(delta)
        if self._cooldown > 0:
            self._cooldown -= 1
            return None
        if not reasons:
            return None
        self._cooldown = self.cfg.cooldown_windows
        return self._replan(delta, window_examples, kind="drift",
                            reasons=reasons)

    # --- the replan itself ----------------------------------------------
    def _live_context(self, delta: SnapshotDelta, window_examples: float):
        """(profiles, fleet) rebuilt from this window's measurements."""
        live_fleet = list(self.fleet)
        if delta.has_ps_traffic:
            live_fleet[self.base_index] = delta.resource(
                self.fleet[self.base_index])
        live_profiles = profile_layers(self.layer_specs, live_fleet)
        if delta.has_ps_traffic and window_examples >= self.cfg.min_examples:
            sync, act = delta.embedding_odt(window_examples)
            live_profiles = [
                apply_measured_odt(p, sync, act)
                if p.kind in _SPARSE_KINDS else p
                for p in live_profiles
            ]
        return live_profiles, live_fleet

    def _replan(self, delta: SnapshotDelta, window_examples: float, *,
                kind: str, reasons: list[str]) -> dict:
        live_profiles, live_fleet = self._live_context(delta,
                                                       window_examples)
        inc_cost, _ = plan_cost(self.incumbent.plan, live_profiles,
                                live_fleet, self.job)
        result = self._run_search(live_profiles, live_fleet,
                                  warm=(self.incumbent.assignment,))
        cand = tuple(result.plan.assignment)
        # apply only past the switch margin (or when the incumbent has
        # become outright infeasible under live conditions)
        better = result.feasible and (
            not math.isfinite(inc_cost)
            or result.cost < inc_cost * (1.0 - self.cfg.switch_margin)
        )
        applied = better and cand != self.incumbent.assignment
        decision = {
            "window": self.windows,
            "kind": kind,
            "reasons": list(reasons),
            "incumbent_cost": inc_cost,
            "candidate_cost": result.cost,
            "applied": applied,
            "from": self.incumbent.assignment,
            "to": cand,
        }
        if applied:
            self.incumbent = Incumbent(cand, result.cost, live_profiles,
                                       live_fleet)
        else:
            # keep the plan but re-score it against measured reality, so
            # the next margin test compares like with like
            self.incumbent = Incumbent(self.incumbent.assignment, inc_cost,
                                       live_profiles, live_fleet)
        # either way the window's rates become the new baseline: the
        # *same* shift must not re-trigger after cooldown
        self.detector.reanchor(ingest_bw=delta.ingest_bw,
                               net_bw=delta.net_bw)
        if kind == "calibrate":
            self.calibrations += 1
        else:
            self.considered += 1
            if applied:
                self.applied += 1
        self.decisions.append(decision)
        return decision

    # --- background loop -------------------------------------------------
    def start(self, interval_s: float | None = None) -> None:
        """Spawn the daemon tick loop (serve path)."""
        if self._thread is not None:
            return
        period = interval_s if interval_s is not None else self.cfg.window_s
        self._stop.clear()

        def loop():
            while not self._stop.wait(period):
                try:
                    self.tick()
                except Exception:  # never take the serving loop down
                    self.errors.append(traceback.format_exc())

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="replan-controller")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    # --- reporting -------------------------------------------------------
    def report(self) -> dict:
        out = {
            "windows": self.windows,
            "calibrations": self.calibrations,
            "considered": self.considered,
            "applied": self.applied,
            "cooldown": self._cooldown,
            "decisions": list(self.decisions),
            "incumbent": {
                "assignment": list(self.incumbent.assignment),
                "cost": self.incumbent.cost,
            },
        }
        if self.admission is not None:
            out["admission"] = self.admission.report()
        if self.errors:
            out["errors"] = list(self.errors)
        return out


def ctr_replan_factory(config: ReplanConfig | None = None, *,
                       scheduler=None, fleet=None, job=None,
                       layer_specs=None, base_index: int = 0, device=None):
    """``ps_fleet -> ReplanController`` factory for the CTR-over-PS
    workload — the shape :func:`repro_torch.ps.workload.train_ctr_elastic`
    takes as its ``replan=`` parameter (``train --sparse-ps --replan``).

    Defaults: the paper's CTR-DNN layer specs scheduled over
    ``default_fleet()`` with a small-budget fused :class:`RLScheduler`
    (re-planning runs *inside* the training loop; a 40-round warm-started
    search is enough because the incumbent anchor already bounds the
    result), run on ``device`` (default ``cuda``).  Snapshots come from
    :func:`~repro_torch.obs.bridge.snapshot_resources` on the PS fleet's
    telemetry plus its live health.
    """

    def build(ps_fleet) -> ReplanController:
        from repro_torch.core.profiles import ctrdnn_layers
        from repro_torch.core.resources import default_fleet
        from repro_torch.obs.bridge import snapshot_resources

        rfleet = list(fleet) if fleet is not None else default_fleet()
        specs = (list(layer_specs) if layer_specs is not None
                 else ctrdnn_layers())
        j = job if job is not None else TrainingJob()
        sched = scheduler
        if sched is None:
            from repro_torch.core.schedulers.rl import RLScheduler

            sched = RLScheduler(rounds=40, plans_per_round=16,
                                early_stop_rounds=15, chunk_rounds=10,
                                device=device)

        def snap() -> dict:
            return snapshot_resources(rfleet[base_index],
                                      telemetry=ps_fleet.telemetry,
                                      fleet=ps_fleet)

        return ReplanController(specs, rfleet, j, sched, snapshot_fn=snap,
                                config=config, base_index=base_index)

    return build
