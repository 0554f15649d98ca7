"""The port's re-planning loop (``repro_torch.obs.bridge``,
``repro_torch.core.replan``) and ``serve --continuous --replan`` against
the JAX reference on the CPU.

Both packages get the same synthetic snapshots (cumulative PS traffic,
serve counters and histograms, fleet health) and the same deterministic
scheduler (``Greedy``), and must reach the same windowed deltas, drift
reasons, admission decisions, re-plan decisions and reports.
"""

from __future__ import annotations

import dataclasses
import json
import math
import threading
import time

import numpy as np
import pytest
import torch

from repro.core import admission as jadm
from repro.core import cost_model as jcm
from repro.core import profiles as jprof
from repro.core import replan as jrp
from repro.core import resources as jres
from repro.core.schedulers import GreedyScheduler as JGreedy
from repro.obs import bridge as jbr
from repro.obs import metrics as jmet
from repro.ps.telemetry import PSTelemetry as JTelemetry
from repro_torch.core import admission as tadm
from repro_torch.core import cost_model as tcm
from repro_torch.core import profiles as tprof
from repro_torch.core import replan as trp
from repro_torch.core import resources as tres
from repro_torch.core.schedulers import GreedyScheduler as TGreedy
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain
from repro_torch.obs import bridge as tbr
from repro_torch.obs import metrics as tmet
from repro_torch.ps.telemetry import PSTelemetry as TTelemetry

#: (reference, port) pairs of each piece the tests run side by side
PKG = {"ref": dict(bridge=jbr, replan=jrp, adm=jadm, res=jres, prof=jprof,
                   job=jcm.TrainingJob(), greedy=JGreedy, met=jmet),
       "port": dict(bridge=tbr, replan=trp, adm=tadm, res=tres, prof=tprof,
                    job=tcm.TrainingJob(), greedy=TGreedy, met=tmet)}
CPU_NET, CPU_INGEST = jres.CPU_CORE.net_bw, jres.CPU_CORE.ingest_bw


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The searches run thousands of tiny ops: with other test workers on
    the same cores, intra-op threads only contend, so hold this module's
    tests to one."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def snap(pull_b=0.0, pull_s=0.0, push_b=0.0, push_s=0.0, *, queue=0.0,
         tokens=0.0, ttft=None, tpot=None, events=None, degraded=False,
         dead=(), **serve):
    """A ``snapshot_resources``-shaped dict from raw cumulative numbers."""
    sig = {"queue_depth": queue, "tokens": tokens, **serve}
    if ttft is not None:
        sig["ttft"] = ttft
    if tpot is not None:
        sig["tpot"] = tpot
    out = {"resource": None, "embedding_odt": (0.0, 0.0), "serve": sig,
           "ps": {"pull": {"bytes": pull_b, "seconds": pull_s, "rows": 0},
                  "push": {"bytes": push_b, "seconds": push_s, "rows": 0}}}
    if events is not None or degraded or dead:
        out["ps_health"] = {"degraded": degraded, "dead_shards": list(dead),
                            "events": dict(events or {})}
    return out


def traffic(scales, **kw):
    """Cumulative snapshots whose windows run at ``scale`` times the CPU
    type's nominal bandwidths."""
    pb = ps_ = qb = qs = 0.0
    out = []
    for scale in scales:
        pull_b = scale * CPU_INGEST
        pb += pull_b
        qb += 2 * scale * CPU_NET - pull_b
        ps_ += 1.0
        qs += 1.0
        out.append(snap(pb, ps_, qb, qs, **kw))
    return out


SNAPS = [
    snap(100.0, 1.0, 50.0, 0.5, queue=2.0, tokens=10.0,
         ttft={"count": 3, "p99": 0.1}, events={"kill": 0}),
    snap(400.0, 2.0, 250.0, 1.5, queue=5.0, tokens=30.0,
         ttft={"count": 7, "p99": 0.4}, tpot={"count": 4, "p99": 0.02},
         events={"kill": 1, "recover": 1}, degraded=True, dead=(2,),
         completed=3.0, timed_out=1.0, good_tokens=12.0, preemptions=2.0,
         resumes=1.0, rejected=4.0),
    snap(400.0, 2.0, 250.0, 1.5, queue=1.0, tokens=30.0),
]


def _asdict(x):
    return json.loads(json.dumps(dataclasses.asdict(x), default=str))


# --- the bridge ------------------------------------------------------------

@pytest.mark.parametrize("pair", [(0, 1), (1, 2), (0, 2)])
def test_snapshot_delta_matches_the_reference(pair):
    prev, cur = SNAPS[pair[0]], SNAPS[pair[1]]
    d = {k: PKG[k]["bridge"].snapshot_delta(prev, cur, 2.5) for k in PKG}
    assert _asdict(d["port"]) == _asdict(d["ref"])
    for prop in ("goodput_tok_per_s", "ingest_bw", "net_bw",
                 "has_ps_traffic"):
        assert getattr(d["port"], prop) == getattr(d["ref"], prop), prop
    for n in (0.0, 64.0, 1000.0):
        assert d["port"].embedding_odt(n) == d["ref"].embedding_odt(n)
    assert _asdict(d["port"].resource(tres.CPU_CORE)) == \
        _asdict(d["ref"].resource(jres.CPU_CORE))


def _registry(met, name):
    reg = met.Registry(name, enabled=True)
    for shard, (b, s) in enumerate(((1000.0, 0.5), (3000.0, 2.0))):
        reg.counter("ps.bytes", dir="pull", shard=shard).inc(b)
        reg.counter("ps.seconds", dir="pull", shard=shard).inc(s)
        reg.counter("ps.rows", dir="pull", shard=shard).inc(b / 8)
        reg.counter("ps.bytes", dir="push", shard=shard).inc(2 * b)
        reg.counter("ps.seconds", dir="push", shard=shard).inc(s / 2)
    reg.gauge("serve.queue_depth").set(3.0)
    for name_ in ("serve.completed", "serve.tokens", "serve.good_tokens"):
        reg.counter(name_).inc(7.0)
    for stream, vals in (("a", (0.01, 0.02)), ("b", (1.0, 2.0, 3.0))):
        for v in vals:
            reg.histogram("serve.ttft_s", stream=stream).record(v)
    reg.histogram("serve.tpot_s").record(0.004)
    return reg


def test_registry_signals_match_the_reference():
    regs = {k: _registry(PKG[k]["met"], f"torch-replan-{k}") for k in PKG}
    closed = {k: _registry(PKG[k]["met"], f"torch-replan-closed-{k}")
              for k in PKG}
    for r in closed.values():
        r.close()
    traffic_ = {k: PKG[k]["bridge"]._ps_traffic([regs[k], closed[k]])
                for k in PKG}
    assert traffic_["port"] == traffic_["ref"]
    sig = {k: PKG[k]["bridge"]._serve_signals(regs[k]) for k in PKG}
    assert sig["port"] == sig["ref"] and sig["port"]["ttft"]["streams"] == 2


def test_snapshot_resources_from_telemetry_matches_the_reference():
    out = {}
    for k, cls in (("ref", JTelemetry), ("port", TTelemetry)):
        tel = cls(2)
        tel.record("pull", rows=np.array([3, 5]), bytes_=np.array([96, 160]),
                   seconds=0.002)
        tel.record("push", rows=np.array([1, 5]), bytes_=np.array([32, 160]),
                   seconds=0.003)
        res = PKG[k]["res"]
        o = PKG[k]["bridge"].snapshot_resources(
            res.CPU_CORE, telemetry=tel, num_examples=128,
            registry=PKG[k]["met"].Registry(f"torch-replan-empty-{k}"))
        tel.close()
        o["resource"] = _asdict(o["resource"])
        out[k] = o
    assert out["port"] == out["ref"]


class _Transport:
    def __init__(self, counters, inner=None):
        self.live_shards = [0, 1]
        self.counters = dict(counters)
        if inner is not None:
            self.inner = inner


class _Fleet:
    """Duck-typed elastic fleet: what ``fleet_health`` reads."""

    def __init__(self, replicas):
        self._mu = threading.Lock()
        self.transport = _Transport({"retries": 2, "hedges": 1},
                                    inner=_Transport({"retries": 3}))
        self.primary = np.array([0, 1, 2, 1])
        self.backup = np.array([1, -1, 0, -1])
        self.replicas = replicas
        self._migrations = {7: None}
        self.events = [{"kind": "kill"}, {"kind": "detected"},
                       {"kind": "join"}]


@pytest.mark.parametrize("replicas", [0, 1])
def test_fleet_health_matches_the_reference(replicas):
    fleet = _Fleet(replicas)
    assert tbr.fleet_health(fleet) == jbr.fleet_health(fleet)


def test_apply_measured_odt_matches_the_reference():
    jp = jprof.paper_model_profiles("NCE", jres.default_fleet())[0]
    tp = tprof.paper_model_profiles("NCE", tres.default_fleet())[0]
    assert _asdict(tbr.apply_measured_odt(tp, 1e-3, 2e-4)) == \
        _asdict(jbr.apply_measured_odt(jp, 1e-3, 2e-4))


# --- detector, actuator, controller -----------------------------------------

DRIFT = (traffic([1.0, 1.0, 1.0, 0.15, 0.15, 0.15, 2.0, 2.0])
         + [snap(queue=q, tokens=t, ttft={"count": c, "p99": p},
                 tpot={"count": c, "p99": p / 10}, events={"kill": e},
                 degraded=g)
            for q, t, c, p, e, g in ((1, 5, 2, 0.5, 0, False),
                                     (9, 9, 4, 0.6, 1, True),
                                     (2, 9, 4, 0.6, 1, True),
                                     (30, 20, 9, 0.01, 1, False))])


@pytest.mark.parametrize("cfg", [
    dict(),
    dict(hysteresis_windows=1, ttft_slo_s=0.1, tpot_slo_s=0.01,
         queue_growth=2.0),
    dict(bw_tolerance=0.2, min_traffic_s=10.0),
])
def test_detector_matches_the_reference(cfg):
    reasons = {}
    for k in PKG:
        br, rp = PKG[k]["bridge"], PKG[k]["replan"]
        det = rp.DriftDetector(rp.ReplanConfig(**cfg), ingest_bw=CPU_INGEST,
                               net_bw=CPU_NET)
        out = []
        for i, (prev, cur) in enumerate(zip(DRIFT, DRIFT[1:])):
            out.append(det.check(br.snapshot_delta(prev, cur, 1.0)))
            if i == 4:
                det.reanchor(ingest_bw=0.15 * CPU_INGEST,
                             net_bw=0.15 * CPU_NET)
        reasons[k] = out
    assert reasons["port"] == reasons["ref"]
    assert any(reasons["port"])


@pytest.mark.parametrize("kw", [
    dict(ttft_slo_s=0.1),
    dict(ttft_slo_s=0.0, decrease=0.25, increase=2, concurrency_after=1),
])
def test_actuator_matches_the_reference(kw):
    windows = [snap(tokens=10.0), snap(tokens=20.0, timed_out=2.0),
               snap(tokens=30.0, timed_out=3.0),
               snap(tokens=40.0, timed_out=3.0, completed=3.0,
                    ttft={"count": 5, "p99": 0.5}),
               snap(tokens=40.0, timed_out=3.0, completed=3.0,
                    ttft={"count": 5, "p99": 0.5}),
               snap(tokens=50.0, timed_out=3.0, completed=9.0,
                    ttft={"count": 9, "p99": 0.05})]
    reports = {}
    for k in PKG:
        policy = PKG[k]["adm"].AdmissionPolicy(slots=4)
        act = PKG[k]["replan"].AdmissionActuator(policy, **kw)
        for prev, cur in zip(windows, windows[1:]):
            act.tune(PKG[k]["bridge"].snapshot_delta(prev, cur, 1.0))
        reports[k] = json.loads(json.dumps(act.report()))
    assert reports["port"] == reports["ref"]
    assert reports["port"]["decisions"]


def _controller(k, *, initial=None, admission=True, **cfg):
    clock = {"t": 0.0}
    pkg = PKG[k]
    policy = pkg["adm"].AdmissionPolicy(slots=4, queue_bound=8)
    cfg = pkg["replan"].ReplanConfig(**{
        "window_steps": 1, "hysteresis_windows": 2, "cooldown_windows": 2,
        **cfg})
    ctl = pkg["replan"].ReplanController(
        pkg["prof"].ctrdnn_layers(), pkg["res"].default_fleet(), pkg["job"],
        pkg["greedy"](), snapshot_fn=lambda: None, config=cfg,
        clock=lambda: clock["t"], initial=initial,
        admission=(pkg["replan"].AdmissionActuator(policy, ttft_slo_s=0.2)
                   if admission else None))

    def observe(s, examples=4096.0):
        clock["t"] += 5.0
        return ctl.observe(examples, snapshot=s)

    return ctl, observe


@pytest.mark.parametrize("initial,cfg", [
    (None, {}),
    ("heuristic", dict(hysteresis_windows=1, cooldown_windows=1,
                       switch_margin=0.0)),
    ("heuristic", dict(calibrate=False, ttft_slo_s=0.1)),
    ("gpu", {}),
])
def test_controller_matches_the_reference(initial, cfg):
    """Calibration, a bandwidth collapse, a recovery and serve SLO
    windows, re-planned by the deterministic ``Greedy`` scheduler over
    profiles rebuilt from the measured rates."""
    layers = jprof.ctrdnn_layers()
    if initial == "heuristic":
        initial = tuple(0 if k in ("embedding", "nce") else 1
                        for k, *_ in layers)
    elif initial == "gpu":
        initial = (1,) * len(layers)
    reports = {}
    for k in PKG:
        ctl, observe = _controller(k, initial=initial, **cfg)
        decisions = [observe(s) for s in DRIFT]
        reports[k] = json.loads(json.dumps(
            {"decisions": decisions, "report": ctl.report()}))
    assert reports["port"] == reports["ref"]
    rep = reports["port"]["report"]
    assert rep["windows"] == len(DRIFT) - 1
    assert rep["calibrations"] + rep["considered"] >= 1
    assert rep["admission"]["decisions"]


def test_controller_background_loop_reports_its_errors():
    """The background thread keeps ticking through a failing snapshot and
    reports each failure instead of swallowing it."""
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] == 2:
            raise OSError("snapshot source went away")
        return snap(tokens=float(calls["n"]), completed=float(calls["n"]))

    policy = tadm.AdmissionPolicy(slots=4)
    ctl = trp.ReplanController(
        tprof.ctrdnn_layers(), tres.default_fleet(), tcm.TrainingJob(),
        TGreedy(), snapshot_fn=flaky, config=trp.ReplanConfig(window_s=0.02),
        initial=(1,) * 16, admission=trp.AdmissionActuator(policy))
    ctl.start()
    deadline = time.monotonic() + 10.0
    while ctl.windows < 2 and time.monotonic() < deadline:
        time.sleep(0.01)
    ctl.stop()
    assert ctl._thread is None
    rep = ctl.report()
    assert rep["windows"] >= 2
    assert len(rep["errors"]) == 1 and "OSError" in rep["errors"][0]
    assert rep["admission"]["decisions"]


# --- the factory and the CLIs ------------------------------------------------

class _PSFleet:
    telemetry = None


def test_ctr_replan_factory_runs_on_the_callers_device():
    ctl = trp.ctr_replan_factory(device="cpu")(_PSFleet())
    assert ctl.scheduler.device == torch.device("cpu")
    assert ctl.scheduler.rounds == 40 and ctl.scheduler.fused
    assert np.isfinite(ctl.incumbent.cost)
    assert len(ctl.incumbent.assignment) == len(tprof.ctrdnn_layers())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            trp.ctr_replan_factory()(_PSFleet())


def test_serve_continuous_replan_cli(capsys):
    """``serve --continuous --replan`` through ``main``: the RL search on
    the CPU at start-up, windows of serve telemetry while it serves."""
    tserve.main(["--reduced", "--continuous", "--replan", "--device", "cpu",
                 "--replan-window-s", "0.02", "--ttft-slo", "5.0"])
    out = json.loads(capsys.readouterr().out)
    assert set(out["outcomes"]) == {"completed"}
    rep = out["replan"]
    assert "errors" not in rep
    assert rep["windows"] >= 1
    assert rep["admission"]["ttft_slo_s"] == 5.0
    assert np.isfinite(rep["incumbent"]["cost"])
    assert len(rep["incumbent"]["assignment"]) == 16


def test_serve_replan_cli_defaults():
    args = tserve.build_parser().parse_args(["--continuous", "--replan"])
    assert (args.replan_window_s, args.ttft_slo, args.tpot_slo) == \
        (1.0, 0.0, 0.0)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tserve.replan_controller(args, tadm.AdmissionPolicy(slots=4))


def test_train_replan_flags_parse():
    args = ttrain.build_parser().parse_args(
        ["--sparse-ps", "--replan", "--replan-window-steps", "5",
         "--replan-bw-tol", "0.3", "--replan-margin", "0.1",
         "--replan-cooldown", "2"])
    assert (args.replan_window_steps, args.replan_bw_tol,
            args.replan_margin, args.replan_cooldown) == (5, 0.3, 0.1, 2)


#: the reference's CTR pin config (tests/test_ps_elastic.py)
CTR_SMALL = dict(vocab=5_000, emb_dim=8, slots=8, tower=(32,), batch=64)
#: a job sized to these runs (ROADMAP.md R5's least change): the paper's
#: 200,000 examples/s leave every plan infeasible (cost inf) or not by
#: the window's host timing, and with it whether a drift re-plan applies;
#: at 1,000 examples/s, the order of a 30-step CPU run's own rate, every
#: plan stays feasible
CTR_SMALL_JOB = 1_000.0


@pytest.mark.parametrize("optimizer,mode", [("sgd", "sync"),
                                            ("adagrad", "sync"),
                                            ("adam", "async")])
def test_train_with_the_replanner_follows_the_reference(optimizer, mode):
    """``train_ctr_elastic(replan=ctr_replan_factory(...))`` from the
    reference's table and tower, ``Greedy`` on both sides: losses within
    1e-4 in sync mode, and in both modes the same windows, calibration
    and drift considerations (the shard kill's edge; bandwidth drift is
    parked out of reach, ``min_traffic_s=inf`` gives no window a
    bandwidth verdict: the windowed bandwidths follow the host's timing
    of the pulls and pushes, and a loaded host read more than 6x the
    calibration window's rate in one package and not the other; the job
    is sized to the run, CTR_SMALL_JOB, so that no plan's feasibility
    turns on that timing)."""
    from repro.ps import workload as jw
    from repro_torch.ps import workload as tw

    import jax

    jcfg, cfg = jw.CTRConfig(**CTR_SMALL), tw.CTRConfig(**CTR_SMALL)
    kw = dict(steps=30, num_shards=3, optimizer=optimizer, mode=mode,
              events=[(20, "kill", 0)])
    ref = jw.train_ctr_elastic(jcfg, **kw, replan=jrp.ctr_replan_factory(
        jrp.ReplanConfig(window_steps=5, bw_tolerance=5.0,
                         min_traffic_s=math.inf),
        scheduler=JGreedy(),
        job=jcm.TrainingJob(throughput_limit=CTR_SMALL_JOB)))
    dense = np.asarray(jax.random.normal(
        jax.random.PRNGKey(jcfg.seed), (jcfg.vocab, jcfg.emb_dim))
        * 0.05, np.float32)
    tower = jax.tree.map(np.asarray,
                         jw.init_tower(jcfg, jax.random.PRNGKey(1)))
    out = tw.train_ctr_elastic(
        cfg, **kw, device="cpu", dense=dense,
        tower=tw.tower_from_numpy(tower, cfg, device="cpu"),
        replan=trp.ctr_replan_factory(
            trp.ReplanConfig(window_steps=5, bw_tolerance=5.0,
                             min_traffic_s=math.inf),
            scheduler=TGreedy(), device="cpu",
            job=tcm.TrainingJob(throughput_limit=CTR_SMALL_JOB)))
    if mode == "sync":
        np.testing.assert_allclose(out["losses"], ref["losses"], rtol=0,
                                   atol=1e-4)
    t, j = out["replan"], ref["replan"]
    for key in ("windows", "calibrations", "considered", "applied"):
        assert t[key] == j[key], key
    assert (t["windows"], t["calibrations"], t["considered"]) == (5, 1, 1)
    assert [(d["kind"], d["reasons"]) for d in t["decisions"]] == \
        [(d["kind"], d["reasons"]) for d in j["decisions"]]
    assert "fleet_events" in t["decisions"][-1]["reasons"]
    assert len(t["incumbent"]["assignment"]) == \
        len(j["incumbent"]["assignment"])
