"""Serving paths of rwkv6-7b, jamba-v0.1-52b, llama-3.2-vision-11b and
whisper-large-v3 against the JAX reference at reduced width, float32 on
the CPU, with the reference's ``init_model`` weights converted through
``params_from_jax``: prefill into the paged pool and the dense rings,
decode steps (logits rtol/atol 1e-4 — the scans round in another order
than ``lax.scan`` / ``associative_scan`` — greedy tokens exact, every
recurrent state and cross k/v the decode reads), ``decode_loop`` (greedy
tokens exact), and R6 (ROADMAP.md): nothing fills the cross k/v when
serving, so a cross layer adds exactly 0, in both packages.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.models import decoder as jdec
from repro_torch.configs import get_config as tget
from repro_torch.models import decoder as tdec
from repro_torch.models.convert import params_from_jax

ARCHS = ("rwkv6-7b", "jamba-v0.1-52b", "llama-3.2-vision-11b",
         "whisper-large-v3")
CROSS_ARCHS = ("llama-3.2-vision-11b", "whisper-large-v3")
TOL = dict(rtol=1e-4, atol=1e-4)
F32J, F32T = jnp.float32, torch.float32

_jprefill = jax.jit(jdec.prefill, static_argnums=1,
                    static_argnames="compute_dtype")
_jstep = jax.jit(jdec.decode_step, static_argnums=1,
                 static_argnames="compute_dtype")
_jloop = jax.jit(jdec.decode_loop, static_argnums=(1, 5),
                 static_argnames="compute_dtype")


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """The reduced models' ops are small; with the suite's other workers
    on the same cores, intra-op threads only contend, so hold this
    module's tests to one."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _models(arch, **over):
    jcfg = dataclasses.replace(jget(arch, reduced=True), **over)
    tcfg = dataclasses.replace(tget(arch, reduced=True), **over)
    jp = jdec.init_model(jcfg, jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    return jcfg, tcfg, jp, tp


@pytest.fixture(scope="module", params=ARCHS)
def models(request):
    return _models(request.param)


def _tokens(B, S, vocab, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (B, S)).astype(
        np.int32)


@pytest.mark.parametrize("arch", CROSS_ARCHS)
def test_cross_layers_add_nothing_when_serving_R6(arch):
    """R6: prefill and decode never fill ``ck``/``cv``, so each cross
    layer attends zeros and adds exactly 0 — in both packages: the
    logits of a prefill and two decode steps are bit-equal with the cross
    weights zeroed, and the cross k/v stay 0."""
    jcfg, tcfg, jp, tp = _models(arch, kv_impl="paged")
    cross = [(j, "cross" if s.mixer == "attn+cross" else "mixer")
             for j, s in enumerate(jcfg.pattern)
             if s.mixer in ("cross_attn", "attn+cross")]

    def zeroed(tree, zeros):
        blocks = list(tree["blocks"])
        for j, key in cross:
            blocks[j] = {**blocks[j], key: {
                k: zeros(v) for k, v in blocks[j][key].items()}}
        return {**tree, "blocks": tuple(blocks)}

    toks = _tokens(2, 12, jcfg.vocab, 3)
    runs = {}
    for name, (jparams, tparams) in {
            "as drawn": (jp, tp),
            "cross zeroed": (zeroed(jp, jnp.zeros_like),
                             zeroed(tp, torch.zeros_like))}.items():
        jc = jdec.init_cache(jcfg, 2, 32, dtype=F32J, page_size=8)
        tc = tdec.init_cache(tcfg, 2, 32, dtype=F32T, page_size=8,
                             device="cpu")
        jl, jc = _jprefill(jparams, jcfg, jnp.asarray(toks), jc,
                              compute_dtype=F32J)
        tl, tc = tdec.prefill(tparams, tcfg, torch.from_numpy(toks), tc,
                              compute_dtype=F32T)
        out = [(np.asarray(jl), tl.numpy())]
        tok = np.asarray(jl)[:, -1:, :jcfg.vocab].argmax(-1).astype(np.int32)
        for _ in range(2):
            jl, jc = _jstep(jparams, jcfg, jnp.asarray(tok), jc, 0,
                                      compute_dtype=F32J)
            tl, tc = tdec.decode_step(tparams, tcfg, torch.from_numpy(tok),
                                      tc, compute_dtype=F32T)
            out.append((np.asarray(jl), tl.numpy()))
        for j, _ in cross:
            for k in ("ck", "cv"):
                assert not np.asarray(jc["layers"][j][k]).any()
                assert not tc["layers"][j][k].any()
        runs[name] = out
    for (ja, ta), (jz, tz) in zip(runs["as drawn"], runs["cross zeroed"]):
        np.testing.assert_array_equal(ja, jz)
        np.testing.assert_array_equal(ta, tz)


@pytest.mark.parametrize("kv_impl", ["paged", "dense"])
def test_prefill_and_decode_steps_match_reference(models, kv_impl):
    """A 20-token prefill (no padding: recurrent mixers fold padding into
    their state) into the paged pool (page size 8) or the dense rings,
    then 8 decode steps: logits rtol/atol 1e-4, greedy tokens exact, and
    every recurrent state and cache row the decode reads."""
    jcfg, tcfg, jp, tp = models
    jcfg = dataclasses.replace(jcfg, kv_impl=kv_impl)
    tcfg = dataclasses.replace(tcfg, kv_impl=kv_impl)
    B, S = 2, 20
    toks = _tokens(B, S, jcfg.vocab, seed=4)
    jc = jdec.init_cache(jcfg, B, 40, dtype=F32J, page_size=8)
    tc = tdec.init_cache(tcfg, B, 40, dtype=F32T, page_size=8, device="cpu")
    jl, jc = _jprefill(jp, jcfg, jnp.asarray(toks), jc, compute_dtype=F32J)
    tl, tc = tdec.prefill(tp, tcfg, torch.from_numpy(toks), tc,
                          compute_dtype=F32T)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    tok = np.asarray(jl)[:, -1:, :jcfg.vocab].argmax(-1).astype(np.int32)
    for i in range(8):
        jl, jc = _jstep(jp, jcfg, jnp.asarray(tok), jc, S + i,
                                  compute_dtype=F32J)
        tl, tc = tdec.decode_step(tp, tcfg, torch.from_numpy(tok), tc, S + i,
                                  compute_dtype=F32T)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        tok = np.asarray(jl)[:, :, :jcfg.vocab].argmax(-1).astype(np.int32)
        np.testing.assert_array_equal(
            tl[:, :, :tcfg.vocab].argmax(-1).numpy(), tok)
    layers = (zip(tc["layers"], jc["layers"]) if kv_impl == "paged"
              else zip(tc, jc))
    for got, want in layers:
        assert got.keys() == want.keys()
        for k in set(got) - {"kp", "vp", "k", "v", "pos"}:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       **TOL, err_msg=k)


def test_decode_loop_greedy_tokens_equal_reference(models):
    """A 16-token prompt and 20 greedy steps through ``decode_loop`` on
    the paged cache."""
    jcfg, tcfg, jp, tp = models
    jcfg = dataclasses.replace(jcfg, kv_impl="paged")
    tcfg = dataclasses.replace(tcfg, kv_impl="paged")
    B, S, steps = 2, 16, 20
    toks = _tokens(B, S, jcfg.vocab, seed=5)
    jc = jdec.init_cache(jcfg, B, 40, dtype=F32J)
    tc = tdec.init_cache(tcfg, B, 40, dtype=F32T, device="cpu")
    jl, jc = _jprefill(jp, jcfg, jnp.asarray(toks), jc, compute_dtype=F32J)
    tl, tc = tdec.prefill(tp, tcfg, torch.from_numpy(toks), tc,
                          compute_dtype=F32T)
    jt = jnp.argmax(jl[:, -1:, :jcfg.vocab], -1).astype(jnp.int32)
    tt = torch.argmax(tl[:, -1:, :tcfg.vocab], -1).to(torch.int32)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    jout, jn, _ = _jloop(jp, jcfg, jt, jc, S, steps, compute_dtype=F32J)
    tout, tn, _ = tdec.decode_loop(tp, tcfg, tt, tc, S, steps,
                                   compute_dtype=F32T)
    np.testing.assert_array_equal(tout.numpy(), np.asarray(jout))
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
