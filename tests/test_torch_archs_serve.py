"""``serve_continuous`` and the serve CLI of chatglm3-6b, gemma2-2b and
internlm2-20b against the JAX reference at reduced width, float32 on the
CPU: with the reference's weights and prompts the token streams,
outcomes and counts are exactly equal (gemma2's longer prompts pass its
window of 32)."""

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

ARCHS = ("chatglm3-6b", "gemma2-2b", "internlm2-20b")


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


#: prompts of 9-50 tokens (gemma2's window of 32 bites in the longer
#: ones), 4-11 generated tokens, two slots: admission waits for a slot
SERVE_REQUESTS = [(50, 6), (9, 11), (37, 4), (21, 8)]
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


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_serves_the_arch_on_cpu(arch, capsys):
    tserve.main(["--arch", arch, "--continuous", "--device", "cpu",
                 "--batch", "2"])
    out = json.loads(capsys.readouterr().out)
    assert out["arch"] == f"{arch}-reduced" and out["device"] == "cpu"
    assert out["outcomes"] == ["completed"] * out["requests"]
    assert out["pool_conserved"] and out["tokens_in_vocab"]


