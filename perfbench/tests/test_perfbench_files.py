"""The benchmark is found from files alone, and BENCHMARK.json keeps the
benchmark contract's shape."""

import json
import re
import types

import pytest

import _tiny  # noqa: F401  (puts perfbench/ on the path)
from harness import spec

ROOT = spec.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def bench():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_every_cell_loads_with_its_files(bench):
    for w in bench["workloads"]:
        cell = spec.load_cell(w["name"])
        # any driver a cell names, found by name as a file of its own
        path = spec._find(cell, "drivers", cell.driver)
        assert path.name == f"{cell.driver}.py"
        assert callable(spec.load_driver(cell).run)
        assert any(m["name"] == "setup_s" for m in cell.end_to_end)
        assert len(cell.end_to_end) >= 2 and cell.per_layer
        for m in cell.per_layer:
            assert callable(spec.load_reader(cell, m["name"]))
            moved = [e["name"] for e in cell.end_to_end]
            assert m["moves"] in moved, (w["name"], m["name"])


def test_names_units_and_keys_follow_the_contract(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in bench[k]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in (
            "host_clock", "device_trace")
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        conf = json.loads((ROOT / c["file"]).read_text())
        assert conf["source"] == c["source"]
        for k in c["reduced"]:
            assert k in conf["published"], k
            assert not re.search(r"(_dim|_rank|size|width|experts_per)", k)
    for w in bench["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
    assert 1 <= bench["run_seconds"] <= 51
    # a full check of 24 cells fits the driver's 43,200 s
    n = 24
    assert (2 + 14 * n) * (bench["run_seconds"] + 60) + n * 180 + 1200 \
        <= 43200


def test_a_cell_mix_config_and_metric_are_added_by_files_alone(tmp_path):
    metric = {"name": "prompt_tokens.tiny", "unit": "tokens",
              "workloads": ["serve-moe"]}
    root = _tiny.write_bench(tmp_path, extra_metrics=[metric])
    (tmp_path / "perfbench" / "metrics").mkdir()
    (tmp_path / "perfbench" / "metrics" / "prompt_tokens.tiny.py").write_text(
        "def read(ctx):\n    return float(sum(ctx.requests.prompt_lens))\n")
    cell = spec.load_cell("serve-moe", root=root,
                          bench_dir=root / "perfbench")
    assert cell.traffic["kind"] == "open_loop"
    assert cell.config["model"]["ffn"] == "moe"
    assert [m["name"] for m in cell.end_to_end] == [
        "ttft_p90_ms", "tpot_p90_ms", "setup_s"]
    assert "prompt_tokens.tiny" in [m["name"] for m in cell.per_layer]
    ctx = types.SimpleNamespace(requests=types.SimpleNamespace(
        prompt_lens=[3, 4]))
    assert spec.load_reader(cell, "prompt_tokens.tiny")(ctx) == 7.0
    # readers and drivers the folder lacks come from the harness
    assert spec.load_reader(cell, "queue_wait_p90_ms")
    assert spec.load_driver(cell).__name__.endswith("serve")
    with pytest.raises(KeyError):
        spec.load_cell("no-such-cell", root=root)


ECHO_DRIVER = '''"""A driver no other cell has: it reports what its cell file says."""


def run(cell, *, seed, seconds, trace, device, t_start):
    p = cell.params
    return {"attempted": 1, "failed": 0, "setup_s": 0.5, "wall_s": seconds,
            "memory_peak_bytes": 0, "e2e": {"echo_s": p["echo"] + seed},
            "trace": None, "spans": [], "switches": [], "t0": None,
            "checks": {"echo_gap": {"value": 0, "limit": 0}},
            "correct": True, "note": "echo"}
'''


def test_a_cell_with_a_driver_of_its_own_is_added_by_files_alone(tmp_path):
    """A third kind of cell: its driver, cell file and metric are new
    files, and the harness finds and runs it by name."""
    import run

    root = _tiny.write_bench(tmp_path, extra_metrics=[
        {"name": "echo_seed.tiny", "unit": "s", "workloads": ["echo"]}])
    pb = root / "perfbench"
    (pb / "drivers").mkdir()
    (pb / "drivers" / "echo.py").write_text(ECHO_DRIVER)
    (pb / "metrics").mkdir()
    (pb / "metrics" / "echo_seed.tiny.py").write_text(
        "def read(ctx):\n    return ctx.e2e['echo_s']\n")
    (pb / "cells" / "echo.json").write_text(json.dumps(
        {"driver": "echo", "echo": 2.0}))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "echo", "config": "tiny-ctr",
                               "traffic": "tiny-ctr", "chips": 1})
    bench["end_to_end"].insert(0, {"name": "echo_s", "unit": "s",
                                   "workloads": ["echo"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = spec.load_cell("echo", root=root, bench_dir=pb)
    out = spec.load_driver(cell).run(cell, seed=3, seconds=1.0, trace=False,
                                     device=None, t_start=0.0)
    dev = {"platform": "cpu", "kind": "cpu", "count": 1,
           "memory_peak_bytes": 0}
    line = run.result_line(cell, out, False, dev)
    assert line["metrics"] == {"echo_s": {"value": 5.0, "unit": "s"},
                               "setup_s": {"value": 0.5, "unit": "s"}}
    traced = run.result_line(cell, out, True, dev)
    assert traced["metrics"] == {"echo_seed.tiny": {"value": 5.0,
                                                    "unit": "s"}}
    assert list(line)[-1] == "checks"


def test_device_trace_aligns_on_the_start_marker_and_finds_idle_gaps():
    from harness.devtrace import DeviceTrace

    def k(name, ts, dur, corr):
        return {"ph": "X", "cat": "kernel", "name": name, "ts": ts,
                "dur": dur, "args": {"correlation": corr}}

    events = [k("spin_kernel", 1000.0, 0.5, 1), k("gemm", 1010.0, 40.0, 2),
              k("void fwd_kernel<bf16>", 1100.0, 50.0, 3),
              k("spin_kernel", 2000.0, 0.5, 4),
              {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
               "ts": 1095.0, "dur": 3.0, "args": {"correlation": 3}}]
    # the host read 5000 µs at the start marker's launch, 6000 at the stop
    t = DeviceTrace.from_events(events, [5000.0, 6000.0], 5000.0, 6010.0)
    assert t.aligned and len(t.ops) == 2
    assert t.ops[0].start == 5010.0 and t.ops[1].launch == 5095.0
    assert t.busy_s() == pytest.approx(90e-6)
    spans = [{"name": "serve.prefill", "ts": 5050.0, "dur": 200.0}]
    gaps = t.idle_gaps(spans, 2)
    assert gaps[0] == ["no program span", pytest.approx(860e-6)]
    assert gaps[1] == ["serve.prefill", pytest.approx(50e-6)]
    assert [o.name for o in t.ops_in(spans[0], ("fwd_kernel",))] == [
        "void fwd_kernel<bf16>"]
    # a trace that lost the first markers aligns on those it kept: the
    # readings at 5400, 5700 and 6000 µs agree on the offset (the markers'
    # correlations follow their launches, the stop marker's last)
    kept = [k("spin_kernel", 1400.0, 0.5, 5), k("spin_kernel", 1703.0, 0.5, 6),
            *events[1:3], k("spin_kernel", 2000.0, 0.5, 7), events[4]]
    late = DeviceTrace.from_events(kept, [5000.0, 5400.0, 5700.0, 6000.0],
                                   5000.0, 6010.0)
    assert late.aligned and late.ops[0].start == 5010.0
    # one reading and no marker kept: unaligned
    none = DeviceTrace.from_events(events[1:3], [5000.0], 5000.0, 6010.0)
    assert not none.aligned


def _marker_trace(starts, launches, kernel_at):
    """Two kept markers (device start, host launch on the trace's clock)
    and one kernel, as a profiler exports them."""
    ev = [{"ph": "X", "cat": "kernel", "name": "gemm", "ts": kernel_at,
           "dur": 100.0, "args": {"correlation": 1}}]
    for i, (ts, launch) in enumerate(zip(starts, launches)):
        ev.append({"ph": "X", "cat": "kernel", "name": "spin_kernel",
                   "ts": ts, "dur": 0.5, "args": {"correlation": 10 + i}})
        if launch is not None:
            ev.append({"ph": "X", "cat": "cuda_runtime",
                       "name": "cudaLaunchKernel", "ts": launch, "dur": 3.0,
                       "args": {"correlation": 10 + i}})
    return ev


@pytest.mark.parametrize("with_launches", [True, False])
def test_device_trace_is_not_aligned_one_step_off(with_launches):
    """One marker a step, steps of ~1.37 s, the trace kept the second and
    third of four markers, and CUPTI placed them 1.2 and 0.2 ms after
    their launches: paired one step off, the readings 7.737 and 9.105 s
    agree on an offset within 50 µs (the slice that read an idle share of
    34.35%).  Paired in launch order by their launches they align right;
    by device starts alone the two pairings tie, and the slice is left
    unaligned rather than shifted by a step."""
    from harness.devtrace import DeviceTrace, align

    reads = [5_000_000.0, 6_368_000.0, 7_737_000.0, 9_105_000.0]
    launches = [r - 4_000_000.0 + 15.0 for r in reads[1:3]]
    starts = [launches[0] + 1200.0, launches[1] + 200.0]
    right = max(reads[1] - starts[0], reads[2] - starts[1])
    t = DeviceTrace.from_events(
        _marker_trace(starts, launches if with_launches else [None, None],
                      kernel_at=starts[0] + 10.0),
        reads, reads[0], reads[-1])
    if with_launches:
        assert t.aligned and t.ops[0].start == starts[0] + 10.0 + right
        assert reads[0] < t.ops[0].start < reads[-1]
    else:
        assert not t.aligned
        assert align(reads, [(s, None) for s in starts])[0] is False
