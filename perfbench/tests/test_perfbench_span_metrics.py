"""The training cell's span metrics (``optimizer_share.train``,
``moe_route_share.train``, ``recompute_share.train``,
``device_ops_per_step.train``) read from a synthetic span list in the
program's trace buffer and a synthetic op list: the shares over whole
steps only, the recompute found by ancestry or, on the autograd engine's
thread, by host time, and None with no spans."""

import types

import pytest

import _tiny  # noqa: F401  (puts perfbench/ on the path)
from harness import obs_spans, spec
from repro_torch import obs
from repro_torch.obs import trace

#: the traced slice: the profiler started at 1,000 µs, stopped at 9,000
SWITCHES = [(990.0, 1000.0), (9000.0, 9010.0)]


class _Spans:
    def __init__(self):
        self.events, self._id = [], 0

    def add(self, name, ts, dur, parent=None, device_ms=None, *, tid=1,
            **args):
        self._id += 1
        args.update(id=self._id, parent=parent)
        if device_ms is not None:
            args["device_ms"] = device_ms
        self.events.append({"name": name, "cat": "train", "ph": "X",
                            "ts": ts, "dur": dur, "pid": 1, "tid": tid,
                            "args": args})
        return self._id


def _step(sp, t0, *, scale=1.0, whole=True, engine=False):
    """One step of 100 device ms (× scale): forward 40 (a layer with its
    route), backward 50 (the recompute one level down, under a span
    between, or with ``engine`` on another thread with no parent), clip
    4, optimizer 6."""
    s = sp.add("train.step", t0, 900, device_ms=100 * scale if whole
               else None, n_micro=1, batch=8, seq=2048)
    f = sp.add("train.forward", t0 + 10, 300, s, 40 * scale)
    sp.add("layer.mixer", t0 + 20, 50, f, 10 * scale, layer=0, kind="attn")
    lf = sp.add("layer.ffn", t0 + 80, 100, f, 20 * scale, layer=0,
                kind="moe")
    sp.add("moe.route", t0 + 90, 10, lf, 3 * scale)
    b = sp.add("train.backward", t0 + 320, 400, s, 50 * scale)
    tid = 2 if engine else 1
    mid = None if engine else sp.add("checkpoint", t0 + 330, 200, b)
    sp.add("layer.mixer", t0 + 340, 40, mid, 8 * scale, tid=tid, layer=0,
           kind="attn")
    lf = sp.add("layer.ffn", t0 + 390, 90, mid, 12 * scale, tid=tid,
                layer=0, kind="moe")
    sp.add("moe.route", t0 + 400, 10, lf, 2 * scale, tid=tid)
    sp.add("train.clip", t0 + 730, 50, s, 4 * scale)
    sp.add("train.optimizer", t0 + 790, 100, s, 6 * scale)


@pytest.fixture
def buffer(monkeypatch):
    buf = trace.TraceBuffer()
    monkeypatch.setattr(obs, "BUFFER", buf)
    return buf


def _ctx(n_ops=50, switches=SWITCHES):
    ops = [types.SimpleNamespace(name=f"k{i}") for i in range(n_ops)]
    return types.SimpleNamespace(trace=types.SimpleNamespace(ops=ops),
                                 switches=switches)


def _read(name, ctx):
    cell = spec.load_cell("olmoe-train-2k")
    return spec.load_reader(cell, name)(ctx)


METRICS = ("optimizer_share.train", "moe_route_share.train",
           "recompute_share.train", "device_ops_per_step.train")


def test_shares_and_ops_over_the_whole_steps_of_the_slice(buffer):
    sp = _Spans()
    _step(sp, 100.0, scale=7.0)            # before the profiler started
    _step(sp, 2000.0)
    _step(sp, 4000.0)
    _step(sp, 6000.0, scale=3.0, whole=False)   # no device time
    _step(sp, 8500.0, scale=5.0)           # runs past the stop
    sp.add("moe.route", 9500.0, 10, None, 99.0)  # outside any step
    buffer.extend(sp.events)
    got = {m: _read(m, _ctx()) for m in METRICS}
    assert got == pytest.approx({
        "optimizer_share.train": 100.0 * (4 + 6) / 100,
        "moe_route_share.train": 100.0 * (3 + 2) / 100,
        "recompute_share.train": 100.0 * (8 + 12) / 100,
        "device_ops_per_step.train": 50 / 2})


def test_every_step_counts_without_a_slice(buffer):
    sp = _Spans()
    _step(sp, 100.0)
    _step(sp, 2000.0, scale=3.0)
    buffer.extend(sp.events)
    ctx = _ctx(n_ops=30, switches=[])
    assert obs_spans.recompute_share(ctx) == pytest.approx(20.0)
    assert obs_spans.device_ops_per_step(ctx) == pytest.approx(15.0)


def test_recompute_is_found_by_ancestry_not_by_parent(buffer):
    sp = _Spans()
    _step(sp, 2000.0)
    buffer.extend(sp.events)
    names = {e["args"]["parent"] for e in sp.events
             if e["name"] == "layer.mixer"}
    assert len(names) == 2            # under train.forward; under a span
    assert obs_spans.recompute_share(_ctx()) == pytest.approx(20.0)


def test_recompute_on_the_engine_thread_is_found_by_host_time(buffer):
    """Parentless layer spans of another thread count under the
    ``train.backward`` whose host interval holds them, and only there."""
    sp = _Spans()
    _step(sp, 2000.0, engine=True)
    _step(sp, 4000.0, engine=True)
    # a parentless layer span outside every backward counts for nothing
    sp.add("layer.ffn", 5000.0, 10, None, 40.0, tid=2, layer=0, kind="moe")
    buffer.extend(sp.events)
    assert not any(e["args"]["parent"] for e in sp.events
                   if e["name"] == "layer.mixer" and e["tid"] == 2)
    got = {m: _read(m, _ctx()) for m in METRICS}
    assert got == pytest.approx({
        "optimizer_share.train": 10.0, "moe_route_share.train": 5.0,
        "recompute_share.train": 20.0, "device_ops_per_step.train": 25.0})


def test_no_spans_read_none(buffer):
    assert all(_read(m, _ctx()) is None for m in METRICS)
    assert obs_spans.device_ops_per_step(
        types.SimpleNamespace(trace=None, switches=SWITCHES)) is None
    # spans of a program without ids or device time (the parent's) count
    # for nothing
    buffer.add({"name": "train.step", "ph": "X", "ts": 2000.0, "dur": 10.0,
                "args": {}})
    assert all(_read(m, _ctx()) is None for m in METRICS)
