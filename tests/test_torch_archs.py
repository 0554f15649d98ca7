"""The dense attention archs chatglm3-6b (partial interleaved RoPE at
fraction 0.5, GQA), gemma2-2b (alternating window-32 local and global
layers, post-norms, embedding scale, attention soft-cap 50 and final
soft-cap 30) and internlm2-20b (GQA) against the JAX reference at reduced
width, float32 on the CPU, with the reference's ``init_model`` weights
converted through ``params_from_jax``: paged prefill and decode steps
(logits and the pools' live rows rtol/atol 1e-4, greedy tokens exact) and
``decode_loop`` on the paged and the dense cache (greedy tokens exact).
gemma2's prompts are longer than its window of 32, so the window bites in
the prefill, in the paged decode and in the dense ring.
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

ARCHS = ("chatglm3-6b", "gemma2-2b", "internlm2-20b")
TOL = dict(rtol=1e-4, atol=1e-4)
F32J, F32T = jnp.float32, torch.float32

_jprefill = jax.jit(jdec.prefill, static_argnums=1,
                    static_argnames="compute_dtype")
_jstep = jax.jit(jdec.decode_step, static_argnums=1,
                 static_argnames="compute_dtype")
_jloop = jax.jit(jdec.decode_loop, static_argnums=(1, 5),
                 static_argnames="compute_dtype")


def _models(arch, **over):
    jcfg = dataclasses.replace(jget(arch, reduced=True), **over)
    tcfg = dataclasses.replace(tget(arch, reduced=True), **over)
    jp = jdec.init_model(jcfg, jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    return jcfg, tcfg, jp, tp


@pytest.fixture(scope="module", params=ARCHS)
def models(request):
    return _models(request.param, kv_impl="paged")


def _prompts(B, S, vocab, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (B, S)).astype(
        np.int32)


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """The reduced models' ops are small; with the suite's other workers
    on the same cores, intra-op threads only contend, so hold this
    module's tests to one."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_window_bites_in_the_reduced_gemma2():
    """The tests below only hold gemma2's local layers if their window is
    shorter than the prompts they see."""
    cfg = tget("gemma2-2b", reduced=True)
    assert [s.window for s in cfg.pattern] == [32, None]
    assert cfg.embed_scale and cfg.final_softcap == 30.0
    assert all(s.post_norm and s.logit_softcap == 50.0 for s in cfg.pattern)


def test_prefill_and_decode_steps_match_reference(models):
    """Right-padded batched prefill into the paged pool (page size 8) and
    decode steps that cross page boundaries; gemma2's longest prompt (45)
    is past its window and its decode steps slide the window over pages."""
    jcfg, tcfg, jp, tp = models
    B, S = 3, 45
    toks = _prompts(B, S, jcfg.vocab, seed=3)
    lengths = np.asarray([45, 38, 5], np.int32)
    jc = jdec.init_cache(jcfg, B, 64, dtype=F32J, page_size=8)
    tc = tdec.init_cache(tcfg, B, 64, dtype=F32T, page_size=8, device="cpu")
    jl, jc = _jprefill(jp, jcfg, jnp.asarray(toks), jc,
                       lengths=jnp.asarray(lengths), compute_dtype=F32J)
    tl, tc = tdec.prefill(tp, tcfg, torch.from_numpy(toks), tc,
                          lengths=torch.from_numpy(lengths),
                          compute_dtype=F32T)
    for b, n in enumerate(lengths):
        np.testing.assert_allclose(tl[b, :n].numpy(), np.asarray(jl)[b, :n],
                                   **TOL)
    # the pools at every live position (what padded positions write is
    # never read: decode attends up to each slot's length)
    table = tc["page_table"].numpy()
    live = [(l, table[b, p // 8], p % 8) for b, n in enumerate(lengths)
            for p in range(n) for l in range(tcfg.repeats)]
    ix = tuple(np.asarray(c) for c in zip(*live))
    for got, want in zip(tc["layers"], jc["layers"]):
        for k in ("kp", "vp"):
            np.testing.assert_allclose(got[k].numpy()[ix],
                                       np.asarray(want[k])[ix], **TOL)
    tok = np.stack([np.asarray(jl)[b, n - 1, :jcfg.vocab].argmax()
                    for b, n in enumerate(lengths)]).astype(np.int32)[:, None]
    ttok = np.stack([tl[b, n - 1, :tcfg.vocab].argmax().item()
                     for b, n in enumerate(lengths)]).astype(np.int32)[:, None]
    np.testing.assert_array_equal(ttok, tok)
    for _ in range(10):
        jl, jc = _jstep(jp, jcfg, jnp.asarray(tok), jc, 0,
                        compute_dtype=F32J)
        tl, tc = tdec.decode_step(tp, tcfg, torch.from_numpy(tok), tc,
                                  compute_dtype=F32T)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        tok = np.asarray(jl)[:, :, :jcfg.vocab].argmax(-1).astype(np.int32)
        np.testing.assert_array_equal(
            tl[:, :, :tcfg.vocab].argmax(-1).numpy(), tok)
    np.testing.assert_array_equal(tc["length"].numpy(), lengths + 10)


@pytest.mark.parametrize("kv_impl", ["paged", "dense"])
def test_decode_loop_greedy_tokens_equal_reference(models, kv_impl):
    """40-token prompts and 24 greedy steps: on the dense cache gemma2's
    local layers keep a 32-slot ring that wraps."""
    jcfg, tcfg, jp, tp = models
    jcfg = dataclasses.replace(jcfg, kv_impl=kv_impl)
    tcfg = dataclasses.replace(tcfg, kv_impl=kv_impl)
    B, S, steps = 2, 40, 24
    toks = _prompts(B, S, jcfg.vocab, seed=1)
    jc = jdec.init_cache(jcfg, B, 72, dtype=F32J)
    tc = tdec.init_cache(tcfg, B, 72, dtype=F32T, device="cpu")
    jl, jc = _jprefill(jp, jcfg, jnp.asarray(toks), jc, compute_dtype=F32J)
    tl, tc = tdec.prefill(tp, tcfg, torch.from_numpy(toks), tc,
                          compute_dtype=F32T)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    jt = jnp.argmax(jl[:, -1:, :jcfg.vocab], -1).astype(jnp.int32)
    tt = torch.argmax(tl[:, -1:, :tcfg.vocab], -1).to(torch.int32)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    jout, jn, _ = _jloop(jp, jcfg, jt, jc, S, steps, compute_dtype=F32J)
    tout, tn, _ = tdec.decode_loop(tp, tcfg, tt, tc, S, steps,
                                   compute_dtype=F32T)
    np.testing.assert_array_equal(tout.numpy(), np.asarray(jout))
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))


def test_init_model_draws_the_reference_tree(models):
    """The port's own init draws the reference's tree (gemma2: the post
    norms; tied embeddings where the config ties them)."""
    _, tcfg, jp, _ = models
    own = tdec.init_model(tcfg, seed=1, device="cpu")
    shapes = jax.tree.map(lambda a: tuple(a.shape), jp)
    assert tdec._tree_map(lambda t: tuple(t.shape), own) == \
        {**shapes, "blocks": tuple(shapes["blocks"])}


