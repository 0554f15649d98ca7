"""``serve_continuous`` and both CLIs for rwkv6-7b, jamba-v0.1-52b,
llama-3.2-vision-11b and whisper-large-v3 at reduced width, float32 on
the CPU: with the reference's weights and prompts the token streams,
outcomes and counts are exactly equal to the reference's; a preempted
and resumed stream of the recurrent archs (resumed by prefilling prompt +
generated tokens into fresh per-slot state) is bit-equal to the same
request served alone; the serve CLI (plain and ``--continuous``) and the
train CLI run each arch with ``--arch <id> --reduced --device cpu``."""

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
from repro_torch.launch import train as ttrain
from repro_torch.models.convert import params_from_jax

ARCHS = ("rwkv6-7b", "jamba-v0.1-52b", "llama-3.2-vision-11b",
         "whisper-large-v3")


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """The reduced models' ops are small; with the suite's other workers
    on the same cores, intra-op threads only contend, so hold this
    module's tests to one."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _fresh_registry():
    tobs.REGISTRY.reset()
    prev = tobs.REGISTRY.enabled
    tobs.REGISTRY.enabled = True
    yield
    tobs.REGISTRY.enabled = prev
    tobs.REGISTRY.reset()


#: prompts of 9-30 tokens, 4-10 generated tokens, two slots: admission
#: waits for a slot, and slots are prefilled over state a finished
#: sequence left behind
SERVE_REQUESTS = [(30, 6), (9, 10), (17, 4), (12, 8)]
EXACT = ("tokens", "generated", "outcomes", "outcome_detail",
         "outcome_counts", "prefills", "preemptions", "resumes",
         "pool_conserved", "peak_pages_in_use", "kv_bytes_per_token_paged",
         "kv_bytes_per_token_dense", "good_tokens")


@pytest.mark.parametrize("arch", ARCHS)
def test_continuous_serve_matches_reference(arch):
    """``serve_continuous`` with the reference's weights and prompts (the
    ones its ``serve_continuous(seed=0)`` draws): token streams, outcomes
    and counts exactly equal."""
    key = jax.random.PRNGKey(0)
    jcfg = jget(arch, reduced=True)
    tp = params_from_jax(jax.tree.map(np.asarray,
                                      jdec.init_model(jcfg, key)),
                         tget(arch, reduced=True), device="cpu")
    prompts = [np.asarray(jax.random.randint(
        jax.random.fold_in(key, 1000 + rid), (1, plen), 0, jcfg.vocab))[0]
        for rid, (plen, _) in enumerate(SERVE_REQUESTS)]
    kw = dict(requests=SERVE_REQUESTS, slots=2, page_size=8, decode_chunk=4)
    want = jserve.serve_continuous(arch, **kw)
    got = tserve.serve_continuous(arch, device="cpu", params=tp,
                                  prompts=prompts, **kw)
    for k in EXACT:
        assert got[k] == want[k], k
    assert got["outcomes"] == ["completed"] * len(SERVE_REQUESTS)
    assert got["generated"] == [g for _, g in SERVE_REQUESTS]
    assert got["pool_conserved"] and got["tokens_in_vocab"]


@pytest.mark.parametrize("arch", ["rwkv6-7b", "jamba-v0.1-52b"])
def test_preempt_resume_bit_exact_against_unpreempted_run(arch):
    """tests/test_admission.py's end-to-end pin on the recurrent archs:
    request 1 blocked on pages preempts request 0, which resumes by
    prefilling its prompt and the tokens it had generated into its new
    slot's state; its stream equals the same request served alone."""
    kw = dict(page_size=4, decode_chunk=4, max_seq_len=36, num_pages=13,
              device="cpu")
    out = tserve.serve_continuous(arch, slots=2, requests=[(8, 24), (8, 4)],
                                  preemption=True, **kw)
    assert out["outcomes"] == ["completed", "completed"]
    assert out["preemptions"] >= 1 and out["resumes"] >= 1
    assert out["pool_conserved"]
    solo = tserve.serve_continuous(arch, slots=1, requests=[(8, 24)], **kw)
    assert out["tokens"][0] == solo["tokens"][0]
    assert out["generated"] == [24, 4]


@pytest.mark.parametrize("mode", [[], ["--continuous"]],
                         ids=["fixed", "continuous"])
@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_serves_the_arch_on_cpu(arch, mode, capsys):
    tserve.main(["--arch", arch, "--reduced", "--device", "cpu",
                 "--batch", "2", "--gen", "6", *mode])
    out = json.loads(capsys.readouterr().out)
    assert out["arch"] == f"{arch}-reduced" and out["device"] == "cpu"
    assert out["tokens_in_vocab"]
    if mode:
        assert out["outcomes"] == ["completed"] * out["requests"]
        assert out["pool_conserved"]
    else:
        assert out["generated_shape"] == [2, 6]


@pytest.mark.parametrize("arch", ARCHS)
def test_train_cli_trains_the_arch_on_cpu(arch, capsys):
    """The audio and vision archs train on the stub context the data
    pipeline draws (their loss needs it)."""
    ttrain.main(["--arch", arch, "--reduced", "--device", "cpu", "--steps",
                 "2", "--batch", "2", "--seq", "16"])
    out = capsys.readouterr().out
    summary = json.loads(out[out.index("{"):])
    assert summary["arch"] == f"{arch}-reduced" and summary["steps"] == 2
    assert summary["devices"] == ["cpu"]
    assert all(np.isfinite(summary["losses"] + summary["grad_norms"]))
