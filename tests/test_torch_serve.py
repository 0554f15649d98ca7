"""The port's serve loops against the JAX reference on the reduced
llama3.2-1b, float32 on the CPU.  The port replays the reference's
weights (``params=``, through ``params_from_jax``) and its ``jax.random``
prompts (``prompts=``); greedy token streams, typed outcomes and, under
the same virtual clock, every latency field are then exactly equal."""

import json

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.launch import serve as jserve
from repro.models import decoder as jdec
from repro_torch import obs as tobs
from repro_torch.configs import get_config as tget
from repro_torch.launch import serve as tserve
from repro_torch.models.convert import params_from_jax

ARCH = "llama3.2-1b"


def _reference_weights_and_prompts(arch):
    """The weights ``serve_continuous(seed=0)`` draws in the reference,
    converted for the port, and the reference's prompt for a request."""
    key = jax.random.PRNGKey(0)
    cfg = jget(arch, reduced=True)
    jp = jdec.init_model(cfg, key)
    tp = params_from_jax(jax.tree.map(np.asarray, jp),
                         tget(arch, reduced=True), device="cpu")

    def prompts(requests):
        return [np.asarray(jax.random.randint(
            jax.random.fold_in(key, 1000 + rid), (1, plen), 0, cfg.vocab))[0]
            for rid, (plen, _) in enumerate(requests)]

    return tp, prompts


@pytest.fixture(scope="module")
def ref():
    return _reference_weights_and_prompts(ARCH)


def ticking_clock(dt=0.01):
    state = {"t": 0.0}

    def clk():
        state["t"] += dt
        return state["t"]

    return clk


@pytest.fixture(autouse=True)
def _fresh_registry():
    tobs.REGISTRY.reset()
    prev = tobs.REGISTRY.enabled
    tobs.REGISTRY.enabled = True
    yield
    tobs.REGISTRY.enabled = prev
    tobs.REGISTRY.reset()


def _port(ref, requests, **kw):
    tp, prompts = ref
    return tserve.serve_continuous(ARCH, device="cpu", params=tp,
                                   prompts=prompts(requests),
                                   requests=requests, **kw)


EXACT = ("tokens", "generated", "outcomes", "outcome_detail",
         "outcome_counts", "prefills", "preemptions", "resumes",
         "pool_conserved", "peak_pages_in_use", "kv_bytes_per_token_paged",
         "kv_bytes_per_token_dense", "good_tokens")


def test_default_mix_matches_reference(ref):
    requests = jserve._default_requests()
    want = jserve.serve_continuous(ARCH)
    got = _port(ref, requests)
    for k in EXACT:
        assert got[k] == want[k], k
    assert got["outcomes"] == ["completed"] * len(requests)
    assert got["pool_conserved"] and got["tokens_in_vocab"]
    assert got["decode_steps"] > 0


SCENARIOS = {
    # test_admission.py's deterministic cases, under one virtual clock
    "queued_ttft_timeout": dict(
        slots=1, page_size=8, decode_chunk=4, requests=[(5, 16), (5, 4)],
        deadlines=[(None, None), (0.05, None)]),
    "mid_decode_total_deadline": dict(
        slots=1, page_size=8, decode_chunk=4, requests=[(5, 64)],
        deadlines=[(None, 0.5)]),
    "wall_budget_shutdown": dict(
        slots=2, page_size=8, decode_chunk=4,
        requests=[(5, 400), (5, 400), (5, 4), (5, 4)], max_wall_s=0.3),
    "preempt_and_resume": dict(
        slots=2, page_size=4, decode_chunk=4, max_seq_len=36, num_pages=13,
        requests=[(8, 24), (8, 4)], preemption=True),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_overload_scenarios_match_reference_under_virtual_clock(ref, name):
    kw = dict(SCENARIOS[name])
    want = jserve.serve_continuous(ARCH, clock=ticking_clock(), **kw)
    requests = kw.pop("requests")
    got = _port(ref, requests, clock=ticking_clock(), **kw)
    for k in EXACT + ("ttft_s", "tpot_s", "total_s", "wall_s"):
        assert got[k] == want[k], k
    assert got["pool_conserved"]


def test_preempt_resume_bit_exact_against_unpreempted_port_run(ref):
    """A preempted-then-resumed stream equals the same request served
    alone (the model is tests/test_admission.py's end-to-end pin)."""
    kw = dict(page_size=4, decode_chunk=4, max_seq_len=36, num_pages=13)
    out = _port(ref, [(8, 24), (8, 4)], slots=2, preemption=True, **kw)
    assert out["outcomes"] == ["completed", "completed"]
    assert out["preemptions"] >= 1 and out["resumes"] >= 1
    assert out["pool_conserved"]
    assert tobs.REGISTRY.value("serve.preemptions") >= 1
    solo = _port(ref, [(8, 24)], slots=1, **kw)
    assert out["tokens"][0] == solo["tokens"][0]
    assert out["generated"] == [24, 4]


def test_fixed_batch_serve_matches_reference(ref):
    tp, _ = ref
    want = jserve.serve(ARCH, batch=2, prompt_len=8, gen=6, kv_impl="paged",
                        decode_chunk=3)
    prompts = np.asarray(jax.random.randint(jax.random.PRNGKey(0), (2, 8), 0,
                                            jget(ARCH, reduced=True).vocab))
    for kv in ("paged", "dense"):
        got = tserve.serve(ARCH, batch=2, prompt_len=8, gen=6, kv_impl=kv,
                           decode_chunk=3, device="cpu", params=tp,
                           prompts=prompts)
        assert got["tokens"] == want["tokens"], kv
        assert got["tokens_in_vocab"]


def test_fixed_batch_sampling_reproducible():
    kw = dict(batch=2, prompt_len=6, gen=5, temperature=0.8, top_k=20,
              top_p=0.9, sample_seed=4, device="cpu")
    a = tserve.serve(ARCH, **kw)
    b = tserve.serve(ARCH, **kw)
    assert a["tokens"] == b["tokens"] and a["tokens_in_vocab"]
    assert a["sampling"]["sample_seed"] == 4


def test_prompts_seam_validates_lengths(ref):
    tp, _ = ref
    with pytest.raises(ValueError, match="prompt_len"):
        tserve.serve_continuous(ARCH, device="cpu", params=tp,
                                requests=[(5, 4)],
                                prompts=[np.zeros(6, np.int32)])


def test_cli_continuous_on_cpu(capsys):
    tserve.main(["--continuous", "--device", "cpu", "--batch", "2"])
    out = json.loads(capsys.readouterr().out)
    assert out["device"] == "cpu"
    assert out["outcomes"] == ["completed"] * out["requests"]
    assert out["pool_conserved"]


def test_cli_reduced_flag_can_select_full_width():
    ap = tserve.build_parser()
    assert ap.parse_args([]).reduced is True
    assert ap.parse_args(["--no-reduced"]).reduced is False
    assert ap.parse_args(["--device", "cuda"]).device == "cuda"


MOE_ARCH = "olmoe-1b-7b"
#: prompts of 5-37 tokens: prefill capacity 8-24 per expert (drops occur
#: at the longer prompts), decode capacity 8
MOE_REQUESTS = [(37, 6), (5, 9), (19, 4)]


def test_olmoe_continuous_serve_matches_reference():
    """Reduced olmoe-1b-7b: greedy token streams, outcomes and counts of
    the continuous-batching serve (MoE in every prefill and decode step)
    exactly equal the reference's."""
    tp, prompts = _reference_weights_and_prompts(MOE_ARCH)
    kw = dict(requests=MOE_REQUESTS, slots=2, page_size=8, decode_chunk=4)
    want = jserve.serve_continuous(MOE_ARCH, **kw)
    got = tserve.serve_continuous(MOE_ARCH, device="cpu", params=tp,
                                  prompts=prompts(MOE_REQUESTS), **kw)
    for k in EXACT:
        assert got[k] == want[k], k
    assert got["decode_steps"] > 0 and got["prefills"] == len(MOE_REQUESTS)
    assert got["outcomes"] == ["completed"] * len(MOE_REQUESTS)
    assert got["generated"] == [g for _, g in MOE_REQUESTS]
    assert got["pool_conserved"] and got["tokens_in_vocab"]


def test_cli_serves_olmoe_on_cpu(capsys):
    tserve.main(["--arch", MOE_ARCH, "--continuous", "--device", "cpu",
                 "--batch", "2"])
    out = json.loads(capsys.readouterr().out)
    assert out["arch"] == "olmoe-1b-7b-reduced" and out["device"] == "cpu"
    assert out["outcomes"] == ["completed"] * out["requests"]
    assert out["pool_conserved"]


def test_serve_raises_without_gpu_unless_cpu_requested(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tserve.serve_continuous(ARCH, requests=[(5, 4)])
