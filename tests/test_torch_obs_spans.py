"""The port's span system (``repro_torch.obs.trace``) and the spans of its
training step, on the CPU: the shared no-op when nothing records, the
span tree of a tiny OLMoE ``make_train_step`` with ``remat`` (the layer
and MoE spans under ``train.forward`` and again, as the recompute, under
``train.backward``), a traced step equal to an untraced one bit for bit,
spans recorded by a ``torch.profiler`` session alone, parents kept to
their thread, no MoE stage spans from serving, and the bounded settling
of device-timed spans."""

import collections
import copy
import json
import os
import subprocess
import sys
import threading
from pathlib import Path

import pytest
import torch

from repro_torch import obs
from repro_torch.configs import get_config
from repro_torch.launch.steps import init_train_state, make_train_step
from repro_torch.obs import trace
from repro_torch.tree import tree_leaves

ROOT = Path(__file__).resolve().parents[1]

PHASES = ("train.forward", "train.backward", "train.clip", "train.optimizer")
MODEL_SPANS = ("layer.mixer", "layer.ffn", "moe.route", "moe.dispatch",
               "moe.experts", "moe.combine")
STEPS = 2


@pytest.fixture
def obs_on(monkeypatch):
    """obs enabled on an empty buffer; disabled and emptied after."""
    monkeypatch.setenv("REPRO_OBS", "0")        # restored after the test
    obs.BUFFER.drain()
    obs.configure(enabled=True)
    try:
        yield obs.BUFFER
    finally:
        obs.configure(enabled=False)
        obs.BUFFER.drain()


def _batch(cfg, seed):
    g = torch.Generator().manual_seed(seed)
    t = torch.randint(0, cfg.vocab, (2, 17), generator=g)
    return {"tokens": t[:, :-1], "labels": t[:, 1:]}


@pytest.fixture(scope="module")
def olmoe_runs():
    """The reduced OLMoE trained ``STEPS`` steps with ``remat`` from one
    state twice: untraced, then with obs on (its spans kept)."""
    cfg = get_config("olmoe-1b-7b", reduced=True)
    params, opt = init_train_state(cfg, seed=0, device="cpu")
    step = make_train_step(cfg, compute_dtype=torch.float32, remat=True,
                           microbatch=None)
    out = {"cfg": cfg}
    for traced in (False, True):
        p, o = copy.deepcopy(params), copy.deepcopy(opt)
        was = os.environ.get("REPRO_OBS")
        obs.BUFFER.drain()
        obs.configure(enabled=traced)
        try:
            for k in range(STEPS):
                p, o, _ = step(p, o, _batch(cfg, k))
        finally:
            obs.configure(enabled=False)
            if was is None:
                os.environ.pop("REPRO_OBS", None)
            else:
                os.environ["REPRO_OBS"] = was
        out[traced] = {"params": p, "opt": o, "spans": obs.BUFFER.drain()}
    return out


def _ancestors(span, by_id):
    out, p = [], span["args"]["parent"]
    while p is not None:
        out.append(by_id[p])
        p = by_id[p]["args"]["parent"]
    return out


def test_span_is_the_shared_noop_when_nothing_records():
    assert not obs.enabled()
    n = len(obs.BUFFER)
    with trace.span("x", k=1) as sp:
        sp.args["more"] = 2
    assert trace.span("x") is trace._NOOP
    assert len(obs.BUFFER) == n


def test_importing_obs_and_a_span_load_no_torch():
    """The PS shard worker imports ``repro_torch.obs`` without torch: a
    span with both switches off looks no profiler up by importing it."""
    code = ("import sys, repro_torch.obs as o\n"
            "from repro_torch.obs import trace\n"
            "with trace.span('x'):\n"
            "    pass\n"
            "print(trace.span('x') is trace._NOOP, len(o.BUFFER), "
            "sorted(k for k in sys.modules if k.split('.')[0] == 'torch'))")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    env.pop("REPRO_OBS", None)
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, timeout=120)
    assert proc.returncode == 0, proc.stderr.decode()
    assert proc.stdout.decode().strip() == "True 0 []"


def test_train_step_span_tree(olmoe_runs):
    cfg, spans = olmoe_runs["cfg"], olmoe_runs[True]["spans"]
    by_id = {s["args"]["id"]: s for s in spans}
    steps = [s for s in spans if s["name"] == "train.step"]
    assert len(steps) == STEPS
    assert all(s["args"]["parent"] is None and s["args"]["n_micro"] == 1
               and s["args"]["batch"] == 2 and s["args"]["seq"] == 16
               for s in steps)
    per_step = []
    for st in steps:
        sid = st["args"]["id"]
        kids = sorted((s for s in spans if s["args"]["parent"] == sid),
                      key=lambda s: s["ts"])
        assert [s["name"] for s in kids] == list(PHASES)
        count = collections.Counter()
        for s in spans:
            up = _ancestors(s, by_id)
            if by_id[sid] not in up:
                continue
            phase = next((a["name"] for a in up if a["name"] in PHASES),
                         None)
            count[s["name"], phase] += 1
            # nested inside its parent on the host clock
            par = by_id[s["args"]["parent"]]
            assert par["ts"] <= s["ts"] <= s["ts"] + s["dur"] <= \
                par["ts"] + par["dur"] + 1.0
        per_step.append(count)
        for name in MODEL_SPANS:
            assert count[name, "train.forward"] == cfg.num_layers, name
            assert count[name, "train.backward"] == cfg.num_layers, name
        assert count["loss.head", "train.forward"] == 1
    assert per_step[0] == per_step[1]
    layers = sorted(s["args"]["layer"] for s in spans
                    if s["name"] == "layer.ffn")
    assert layers == sorted(list(range(cfg.num_layers)) * 2 * STEPS)
    assert {s["args"]["kind"] for s in spans
            if s["name"] == "layer.ffn"} == {"moe"}
    assert {s["args"]["kind"] for s in spans
            if s["name"] == "layer.mixer"} == {"attn"}
    # no CUDA in use: no device time
    assert not any("device_ms" in s["args"] for s in spans)


def test_traced_step_equals_untraced_bit_for_bit(olmoe_runs):
    a, b = olmoe_runs[False], olmoe_runs[True]
    assert not a["spans"] and b["spans"]
    for get in (lambda r: r["params"], lambda r: r["opt"].mu,
                lambda r: r["opt"].nu, lambda r: r["opt"].count):
        la, lb = tree_leaves(get(a)), tree_leaves(get(b))
        assert len(la) == len(lb) > 0
        for x, y in zip(la, lb):
            assert torch.equal(x, y)


def test_profiler_session_records_spans_and_annotations(tmp_path):
    """With obs off, a ``torch.profiler`` session alone makes spans record,
    into the buffer and as ``user_annotation`` events of its trace."""
    assert not obs.enabled()
    obs.BUFFER.drain()
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])
    with prof:
        with trace.span("outer"):
            with trace.span("inner", k=1):
                torch.ones(4).sum()
    assert trace.span("after") is trace._NOOP
    got = {e["name"]: e for e in obs.BUFFER.drain()}
    assert set(got) == {"outer", "inner"}
    assert got["inner"]["args"] == {"k": 1, "id": got["inner"]["args"]["id"],
                                    "parent": got["outer"]["args"]["id"]}
    path = tmp_path / "prof.json"
    prof.export_chrome_trace(str(path))
    ann = [e["name"] for e in json.loads(path.read_text())["traceEvents"]
           if e.get("cat") == "user_annotation"]
    assert sorted(ann) == ["inner", "outer"]


def test_parents_do_not_cross_threads(obs_on):
    """A span opened on a thread with no open span of its own has no
    parent, whatever is open on other threads (the autograd engine's
    thread; the benchmark's readers place its spans by host time)."""
    def worker():
        with trace.span("orphan"):
            with trace.span("child"):
                pass

    with trace.span("backward"):
        t = threading.Thread(target=worker)
        t.start()
        t.join(timeout=30)
    assert not t.is_alive()
    ev = {e["name"]: e for e in obs_on.drain()}
    assert ev["orphan"]["args"]["parent"] is None
    assert ev["child"]["args"]["parent"] == ev["orphan"]["args"]["id"]
    assert ev["backward"]["ts"] <= ev["orphan"]["ts"]
    assert ev["orphan"]["ts"] + ev["orphan"]["dur"] <= \
        ev["backward"]["ts"] + ev["backward"]["dur"]


def test_moe_stage_spans_come_from_training_alone(obs_on):
    """``moe_ffn`` (training) records the four stage spans; serving's
    ``moe_forward`` records none."""
    from repro_torch.nn import moe as moe_mod

    p = moe_mod.init_moe(torch.Generator().manual_seed(0), 8, 16, 4)
    x = torch.randn(2, 5, 8, generator=torch.Generator().manual_seed(1))
    y_serve = moe_mod.moe_forward(p, x, top_k=2)
    assert not obs_on.drain()
    y_train, _ = moe_mod.moe_ffn(p, x, top_k=2)
    assert [e["name"] for e in obs_on.drain()] == [
        "moe.route", "moe.dispatch", "moe.experts", "moe.combine"]
    assert torch.equal(y_serve, y_train)


class _FakeEvent:
    """A CUDA event stand-in: done once ``done`` is set; records waits."""

    def __init__(self, t, done=False):
        self.t, self.done, self.waited = t, done, False

    def query(self):
        return self.done

    def synchronize(self):
        self.waited = self.waited or not self.done
        self.done = True

    def elapsed_time(self, end):
        return end.t - self.t


def test_device_pairs_settle_when_finished_or_read(monkeypatch):
    buf = trace.TraceBuffer()
    e1, e2 = {"args": {}}, {"args": {}}
    a1, b1 = _FakeEvent(1.0), _FakeEvent(3.5)
    buf.add_timed(e1, a1, b1)
    assert "device_ms" not in e1["args"]           # not finished: pending
    b1.done = True
    buf.add_timed(e2, _FakeEvent(4.0), _FakeEvent(9.0))
    assert e1["args"]["device_ms"] == 2.5 and not b1.waited
    assert "device_ms" not in e2["args"]
    assert [e["args"]["device_ms"] for e in buf.events()] == [2.5, 5.0]
    # past MAX_PENDING the oldest pair is waited for
    monkeypatch.setattr(trace, "MAX_PENDING", 2)
    ends = [_FakeEvent(float(i)) for i in range(4)]
    for end in ends:
        buf.add_timed({"args": {}}, _FakeEvent(0.0), end)
    assert [e.waited for e in ends] == [True, True, False, False]
    assert len(buf._pending) == 2
    assert len(buf.drain()) == 6 and not buf._pending


def test_chrome_trace_carries_a_clock_anchor(obs_on, tmp_path):
    with trace.span("x"):
        pass
    path = trace.write_chrome(str(tmp_path / "t.json"))
    doc = json.loads(Path(path).read_text())
    anchor = doc["clock_anchor"]
    assert set(anchor) == {"perf_counter_ns", "time_ns"}
    x = next(e for e in doc["traceEvents"] if e["name"] == "x")
    assert x["ts"] * 1e3 <= anchor["perf_counter_ns"]
