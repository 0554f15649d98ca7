"""The port's ``repro_torch.examples.observability`` against the
reference's ``examples/observability.py`` on the CPU, and what every
example shares: its flags, its ``python -m`` entry and its refusal to
run without a GPU unless asked for the CPU.

Both run whole: 20 sparse-PS steps over two shard processes, then four
requests served with open-loop arrivals, the cost-model bridge and the
flush.  The merged ``trace.json`` must hold the main process's lane and
one per shard worker (3), with the reference's set of span names; the
printed lines must match but for the measured numbers and the run
directory.  Each package's instrumentation switch and ``REPRO_OBS`` are
put back after its run, so the tests that follow in this process run
uninstrumented.
"""

from __future__ import annotations

import contextlib
import importlib
import io
import os
import re
import subprocess
import sys

import pytest
import torch

from _torch_examples import ROOT, load_reference, one_thread
from repro_torch import obs
from repro_torch.examples import observability as tobs

EXAMPLES = ("quickstart", "serve_decode", "schedule_all_archs",
            "observability", "heterps_ctr_pipeline")
#: the reference's flags (only the CTR pipeline takes any)
REFERENCE_FLAGS = {"heterps_ctr_pipeline": {"--steps", "--lr", "--chaos"}}


@pytest.fixture(scope="module", autouse=True)
def _threads():
    yield from one_thread()


def _run(fn):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn()
    return out, buf.getvalue().splitlines()


def _trace_facts(path: str) -> tuple[int, set[str]]:
    import json

    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return len({e["pid"] for e in events}), {e["name"] for e in events}


@pytest.fixture(scope="module")
def reference():
    from repro import obs as jobs

    ref = load_reference("observability")
    was = jobs.enabled()
    jobs.BUFFER.drain()
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("REPRO_OBS", raising=False)   # restored on exit
        try:
            _, lines = _run(ref.main)
        finally:
            jobs.configure(enabled=was)
    path = re.search(r"wrote (\S+trace\.json)", lines[-1]).group(1)
    return {"lines": lines, "trace": _trace_facts(path)}


@pytest.fixture(scope="module")
def port():
    env, was = os.environ.get("REPRO_OBS"), obs.enabled()
    obs.BUFFER.drain()
    out, lines = _run(lambda: tobs.main(["--device", "cpu"]))
    return {"out": out, "lines": lines, "trace": _trace_facts(out["trace"]),
            "before": (env, was),
            "after": (os.environ.get("REPRO_OBS"), obs.enabled())}


def test_trace_has_a_lane_per_process(reference, port):
    assert port["out"]["lanes"] == port["trace"][0] == reference["trace"][0]
    assert port["out"]["lanes"] == 3


def test_trace_has_the_reference_span_names(reference, port):
    assert port["trace"][1] == reference["trace"][1]
    assert set(port["out"]["span_names"]) == port["trace"][1]


def test_serves_every_request(port):
    out = port["out"]
    assert out["requests"] == len(tobs.REQUESTS)
    assert out["generated"] == [g for _, g in tobs.REQUESTS]
    assert 0 < out["ttft_p50_s"] <= out["ttft_p99_s"]


def _unmeasured(line: str) -> str:
    line = re.sub(r"\S+/obsrun-\S+/", "<run-dir>/", line)
    return " ".join(re.sub(r"[0-9]+(\.[0-9]+)?", "#", line).split())


def test_prints_the_reference_lines(reference, port):
    assert ([_unmeasured(s) for s in port["lines"]]
            == [_unmeasured(s) for s in reference["lines"]])
    assert port["out"]["resource"] == "cpu+obs"


def test_leaves_instrumentation_as_it_found_it(port):
    assert port["after"] == port["before"]


def _flags(text: str) -> set[str]:
    return set(re.findall(r"(?<![\w-])--[a-z][a-z-]*", text)) - {"--help"}


@pytest.mark.parametrize("name", EXAMPLES)
def test_flags_are_the_reference_flags_and_device(name):
    """Each example takes the reference's flags plus ``--device``
    (default ``cuda``); the reference's CTR pipeline lists its own in
    ``--help``, the other four take none."""
    mod = importlib.import_module(f"repro_torch.examples.{name}")
    parser = mod.build_parser()
    assert parser.get_default("device") == "cuda"
    want = REFERENCE_FLAGS.get(name, set())
    if want:
        ref_help = subprocess.run(
            [sys.executable, str(ROOT / "examples" / f"{name}.py"), "--help"],
            cwd=ROOT, capture_output=True, text=True, timeout=120,
            check=True).stdout
        assert _flags(ref_help) == want
    assert _flags(parser.format_help()) == want | {"--device"}


@pytest.mark.parametrize("name", EXAMPLES)
def test_runs_as_a_module(name):
    """``python -m repro_torch.examples.<name> --help`` exits 0 (the
    ``-m`` entry parses its flags before any work)."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    done = subprocess.run(
        [sys.executable, "-m", f"repro_torch.examples.{name}", "--help"],
        cwd=ROOT, capture_output=True, text=True, timeout=120, env=env)
    assert done.returncode == 0, done.stderr
    assert "--device" in done.stdout


@pytest.mark.parametrize("name,argv", [
    *((name, []) for name in EXAMPLES),
    ("heterps_ctr_pipeline", ["--chaos"]),
])
def test_defaults_to_cuda(name, argv):
    """Without ``--device`` an example runs on ``cuda`` and raises where
    there is none, before any work: none falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    mod = importlib.import_module(f"repro_torch.examples.{name}")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main(argv)
