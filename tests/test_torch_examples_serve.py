"""The port's ``repro_torch.examples.serve_decode`` against the reference's
``examples/serve_decode.py`` on the CPU.

Both examples run whole: four reduced archs, the paged run and the
continuous loop.  The continuous loop serves the first 4 requests of the
default mix in both (``serve_continuous`` called with ``requests=``
through ``monkeypatch``): the reference compiles a prefill for every
prompt length, and the 12 default requests take it ~20 s.  Shapes,
``tokens_in_vocab``, ``kv_bytes_per_token``, the paged/dense KV ratio,
the request count, the generated lengths and the pool's conservation
must equal the reference's; the printed lines must match but for the
measured tok/s.
"""

from __future__ import annotations

import contextlib
import io
import re

import pytest

from _torch_examples import (load_chip_smoke, load_reference, one_thread,
                             record_calls)
from repro_torch.examples import serve_decode as tsd

ARCHS = ("llama3.2-1b", "gemma2-2b", "rwkv6-7b", "jamba-v0.1-52b")
#: the first 4 of ``serve_continuous``'s default mix of 12
REQUESTS = [(8 + (7 * i) % 25, 6 + (5 * i) % 15) for i in range(4)]


@pytest.fixture(scope="module", autouse=True)
def _threads():
    yield from one_thread()


def _run(fn):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn()
    return out, buf.getvalue().splitlines()


@pytest.fixture(scope="module")
def reference():
    ref = load_reference("serve_decode")
    with pytest.MonkeyPatch.context() as mp:
        served = record_calls(mp, ref, "serve")
        cont = record_calls(mp, ref, "serve_continuous", requests=REQUESTS)
        _, lines = _run(ref.main)
    return {"served": served, "continuous": cont[0], "lines": lines}


@pytest.fixture(scope="module")
def port():
    with pytest.MonkeyPatch.context() as mp:
        record_calls(mp, tsd, "serve_continuous", requests=REQUESTS)
        out, lines = _run(lambda: tsd.main(["--device", "cpu"]))
    return {"out": out, "lines": lines}


@pytest.mark.parametrize("i,arch", list(enumerate(ARCHS)))
def test_each_cache_family_follows_the_reference(reference, port, i, arch):
    ref = reference["served"][i]
    got = port["out"]["archs"][arch]
    assert ref["arch"].startswith(arch)
    assert got["generated_shape"] == ref["generated_shape"] == [4, 16]
    assert got["tokens_in_vocab"] is ref["tokens_in_vocab"] is True


def test_paged_run_follows_the_reference(reference, port):
    ref, got = reference["served"][len(ARCHS)], port["out"]["paged"]
    assert ref["kv_impl"] == "paged"
    assert got["generated_shape"] == ref["generated_shape"]
    assert got["tokens_in_vocab"] is ref["tokens_in_vocab"] is True
    assert got["kv_bytes_per_token"] == ref["kv_bytes_per_token"] == 32768


def test_continuous_batching_follows_the_reference(reference, port):
    ref, got = reference["continuous"], port["out"]["continuous"]
    ref_ratio = (ref["kv_bytes_per_token_paged"]
                 / ref["kv_bytes_per_token_dense"])
    assert got["requests"] == ref["requests"] == len(REQUESTS)
    assert got["generated"] == ref["generated"] == [g for _, g in REQUESTS]
    assert got["kv_ratio"] == pytest.approx(ref_ratio, rel=1e-12)
    assert got["pool_conserved"] is ref["pool_conserved"] is True


def _unmeasured(line: str) -> str:
    return re.sub(r"decode +[0-9.]+ tok/s", "decode <tok/s>", line)


def test_prints_the_reference_lines(reference, port):
    assert ([_unmeasured(s) for s in port["lines"]]
            == [_unmeasured(s) for s in reference["lines"]])


def test_chip_smoke_serve_numbers_are_the_reference_numbers(reference):
    """``REF_SERVE``, which phase 19 holds the card's run to: the
    reference's shapes and KV bytes, and its continuous loop's default
    mix of 12 requests."""
    from repro.launch.serve import _default_requests

    cs = load_chip_smoke()
    paged = reference["served"][len(ARCHS)]
    assert cs.REF_SERVE["generated_shape"] == paged["generated_shape"]
    assert cs.REF_SERVE["kv_bytes_per_token"] == paged["kv_bytes_per_token"]
    mix = _default_requests()
    assert cs.REF_SERVE["requests"] == len(mix)
    assert cs.REF_SERVE["generated"] == [g for _, g in mix]
    assert mix[:len(REQUESTS)] == REQUESTS
