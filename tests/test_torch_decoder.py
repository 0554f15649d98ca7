"""The port's decoder against the JAX reference on the reduced
llama3.2-1b (2 layers, d 256, 8 heads, 2 KV heads, hd 32), float32 on
the CPU, with the reference's ``init_model`` weights converted through
``params_from_jax``.  Logits hold at rtol/atol 1e-4 (float32 matmuls over
d ≤ 512, summed in another order, through two layers); greedy tokens and
sampled tokens under shared Gumbel noise are exact."""

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

TOL = dict(rtol=1e-4, atol=1e-4)
ARCH = "llama3.2-1b"
F32J, F32T = jnp.float32, torch.float32

# the reference, jitted (eager JAX dispatch is slow); cfg is static
_jprefill = jax.jit(jdec.prefill, static_argnums=1,
                    static_argnames="compute_dtype")
_jstep = jax.jit(jdec.decode_step, static_argnums=1,
                 static_argnames="compute_dtype")
_jloop = jax.jit(jdec.decode_loop, static_argnums=(1, 5),
                 static_argnames="compute_dtype")


@pytest.fixture(scope="module")
def models():
    jcfg = dataclasses.replace(jget(ARCH, reduced=True), kv_impl="paged")
    tcfg = dataclasses.replace(tget(ARCH, reduced=True), kv_impl="paged")
    jp = jdec.init_model(jcfg, jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    return jcfg, tcfg, jp, tp


def _prompts(B, S, vocab, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (B, S)).astype(
        np.int32)


def test_converted_tree_matches_reference_shapes(models):
    _, tcfg, jp, tp = models
    jl = jax.tree_util.tree_leaves_with_path(jp)
    flat = {jax.tree_util.keystr(k): np.asarray(v) for k, v in jl}
    assert flat["['embed']"].shape == (tcfg.padded_vocab, tcfg.d_model)
    np.testing.assert_array_equal(tp["blocks"][0]["mixer"]["wq"].numpy(),
                                  flat["['blocks'][0]['mixer']['wq']"])
    # the port's own init draws the same tree (shapes and dtypes)
    own = tdec.init_model(tcfg, seed=3, device="cpu")
    shapes = jax.tree.map(lambda a: tuple(a.shape), jp)
    assert tdec._tree_map(lambda t: tuple(t.shape), own) == \
        {**shapes, "blocks": tuple(shapes["blocks"])}


def test_init_model_scales(models):
    """The port's init has the reference's per-leaf scale (std within 5%
    of 1/sqrt(fan_in)) and its unit norms."""
    _, tcfg, _, _ = models
    p = tdec.init_model(tcfg, seed=0, device="cpu")
    d = tcfg.d_model
    assert abs(p["embed"].std().item() * d ** 0.5 - 1) < 0.05
    assert abs(p["blocks"][0]["ffn"]["w2"].std().item()
               * tcfg.d_ff ** 0.5 - 1) < 0.05
    assert torch.equal(p["final_norm"], torch.ones(d))


def test_entry_points_default_to_cuda(models, monkeypatch):
    _, tcfg, _, _ = models
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tdec.init_model(tcfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tdec.init_cache(tcfg, 1, 16)


def test_prefill_and_decode_steps_match_reference(models):
    jcfg, tcfg, jp, tp = models
    B, S = 3, 13
    toks = _prompts(B, S, jcfg.vocab)
    lengths = np.asarray([13, 7, 1], np.int32)
    jc = jdec.init_cache(jcfg, B, 48, dtype=F32J, page_size=8)
    tc = tdec.init_cache(tcfg, B, 48, dtype=F32T, page_size=8, device="cpu")
    jl, jc = _jprefill(jp, jcfg, jnp.asarray(toks), jc,
                       lengths=jnp.asarray(lengths), compute_dtype=F32J)
    tl, tc = tdec.prefill(tp, tcfg, torch.from_numpy(toks), tc,
                          lengths=torch.from_numpy(lengths),
                          compute_dtype=F32T)
    for b, n in enumerate(lengths):
        np.testing.assert_allclose(tl[b, :n].numpy(), np.asarray(jl)[b, :n],
                                   **TOL)
    np.testing.assert_array_equal(tc["length"].numpy(), lengths)
    tok = np.stack([np.asarray(jl)[b, n - 1, :jcfg.vocab].argmax()
                    for b, n in enumerate(lengths)]).astype(np.int32)[:, None]
    for _ in range(6):          # crosses the 8-token page boundary
        jl, jc = _jstep(jp, jcfg, jnp.asarray(tok), jc, 0,
                        compute_dtype=F32J)
        tl, tc = tdec.decode_step(tp, tcfg, torch.from_numpy(tok), tc,
                                  compute_dtype=F32T)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        tok = np.asarray(jl)[:, :, :jcfg.vocab].argmax(-1).astype(np.int32)


def test_decode_loop_greedy_tokens_equal_reference(models):
    jcfg, tcfg, jp, tp = models
    B, S, steps = 2, 9, 12
    toks = _prompts(B, S, jcfg.vocab, seed=1)
    jc = jdec.init_cache(jcfg, B, 32, dtype=F32J)
    tc = tdec.init_cache(tcfg, B, 32, dtype=F32T, device="cpu")
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


def test_paged_equals_dense_in_the_port(models):
    _, tcfg, _, tp = models
    dcfg = dataclasses.replace(tcfg, kv_impl="dense")
    B, S, steps = 2, 10, 9
    toks = torch.from_numpy(_prompts(B, S, tcfg.vocab, seed=2))
    outs = []
    for cfg in (tcfg, dcfg):
        cache = tdec.init_cache(cfg, B, 32, dtype=F32T, page_size=4,
                                device="cpu")
        lg, cache = tdec.prefill(tp, cfg, toks, cache, compute_dtype=F32T)
        tok = torch.argmax(lg[:, -1:, :cfg.vocab], -1).to(torch.int32)
        logits = []
        for i in range(steps):
            lg, cache = tdec.decode_step(tp, cfg, tok, cache, S + i,
                                         compute_dtype=F32T)
            logits.append(lg)
            tok = torch.argmax(lg[:, :, :cfg.vocab], -1).to(torch.int32)
        outs.append(torch.cat(logits, 1))
    torch.testing.assert_close(outs[0], outs[1], rtol=1e-5, atol=1e-5)


def test_slot_cache_prefill_merges_into_the_pool(models):
    """Per-admission prefill through a slot view writes the shared pool in
    place and only the slot's length moves."""
    _, tcfg, _, tp = models
    cache = tdec.init_cache(tcfg, 3, 16, dtype=F32T, page_size=4,
                            device="cpu")
    sub = tdec.slot_cache(cache, 1)
    _, sub = tdec.prefill(tp, tcfg, torch.from_numpy(
        _prompts(1, 6, tcfg.vocab)), sub, compute_dtype=F32T)
    merged = tdec.merge_slot_cache(cache, sub, 1)
    assert merged["length"].tolist() == [0, 6, 0]
    kp = merged["layers"][0]["kp"]
    first = cache["page_table"][1, 0].item()
    assert kp[:, first].abs().sum() > 0           # slot 1's page was written
    assert kp[:, cache["page_table"][0, 0].item()].abs().sum() == 0


@pytest.mark.parametrize("temperature,top_k,top_p", [
    (1.0, 0, 1.0), (0.7, 0, 1.0), (1.3, 5, 1.0), (0.9, 0, 0.8),
    (0.8, 12, 0.9)])
def test_sample_logits_with_shared_gumbel_noise(temperature, top_k, top_p):
    """``jax.random.categorical`` is argmax(logits + gumbel(key)): feeding
    the port the same Gumbel samples gives the same tokens."""
    logits = np.random.default_rng(5).standard_normal((6, 64)).astype(
        np.float32) * 3
    key = jax.random.PRNGKey(11)
    want = jdec.sample_logits(jnp.asarray(logits), key,
                              temperature=temperature, top_k=top_k,
                              top_p=top_p)
    noise = np.array(jax.random.gumbel(key, logits.shape, jnp.float32))
    got = tdec.sample_logits(torch.from_numpy(logits),
                             temperature=temperature, top_k=top_k,
                             top_p=top_p, noise=torch.from_numpy(noise))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_sample_logits_generator_is_reproducible_and_filtered():
    logits = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (4, 50)).astype(np.float32))
    draws = []
    for _ in range(2):
        g = torch.Generator().manual_seed(3)
        draws.append(tdec.sample_logits(logits, g, temperature=0.9,
                                        top_k=3))
    assert torch.equal(draws[0], draws[1])
    top3 = torch.topk(logits, 3, dim=-1).indices
    assert all(int(t) in top3[i].tolist() for i, t in enumerate(draws[0]))


# --------------------------------------------------------------------------
# MoE archs: reduced olmoe-1b-7b and qwen3-moe-30b-a3b (2 layers, d 256,
# 4 experts, top-2, qk-norm), float32 on the CPU
# --------------------------------------------------------------------------

MOE_ARCHS = ("olmoe-1b-7b", "qwen3-moe-30b-a3b")


@pytest.fixture(scope="module", params=MOE_ARCHS)
def moe_models(request):
    jcfg = dataclasses.replace(jget(request.param, reduced=True),
                               kv_impl="paged")
    tcfg = dataclasses.replace(tget(request.param, reduced=True),
                               kv_impl="paged")
    jp = jdec.init_model(jcfg, jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    return jcfg, tcfg, jp, tp


def test_moe_prefill_and_decode_steps_match_reference(moe_models):
    """Right-padded batched prefill (the MoE routes each sequence as one
    group of S tokens, drops included) and one-token decode steps (one
    group per slot, capacity 8) against the reference's auto path."""
    jcfg, tcfg, jp, tp = moe_models
    B, S = 3, 21
    toks = _prompts(B, S, jcfg.vocab, seed=7)
    lengths = np.asarray([21, 12, 3], np.int32)
    jc = jdec.init_cache(jcfg, B, 40, dtype=F32J, page_size=8)
    tc = tdec.init_cache(tcfg, B, 40, dtype=F32T, page_size=8, device="cpu")
    jl, jc = _jprefill(jp, jcfg, jnp.asarray(toks), jc,
                       lengths=jnp.asarray(lengths), compute_dtype=F32J)
    tl, tc = tdec.prefill(tp, tcfg, torch.from_numpy(toks), tc,
                          lengths=torch.from_numpy(lengths),
                          compute_dtype=F32T)
    for b, n in enumerate(lengths):
        np.testing.assert_allclose(tl[b, :n].numpy(), np.asarray(jl)[b, :n],
                                   **TOL)
    tok = np.stack([np.asarray(jl)[b, n - 1, :jcfg.vocab].argmax()
                    for b, n in enumerate(lengths)]).astype(np.int32)[:, None]
    for _ in range(5):
        jl, jc = _jstep(jp, jcfg, jnp.asarray(tok), jc, 0,
                        compute_dtype=F32J)
        tl, tc = tdec.decode_step(tp, tcfg, torch.from_numpy(tok), tc,
                                  compute_dtype=F32T)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        tok = np.asarray(jl)[:, :, :jcfg.vocab].argmax(-1).astype(np.int32)


def test_moe_decode_loop_greedy_tokens_equal_reference(moe_models):
    jcfg, tcfg, jp, tp = moe_models
    B, S, steps = 2, 11, 10
    toks = _prompts(B, S, jcfg.vocab, seed=8)
    jc = jdec.init_cache(jcfg, B, 32, dtype=F32J)
    tc = tdec.init_cache(tcfg, B, 32, dtype=F32T, device="cpu")
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


def test_moe_init_model_tree_and_scales(moe_models):
    """The port's own init draws the reference's tree (router (R, d, E),
    experts (R, E, d, f) / (R, E, f, d)) with its per-leaf scales."""
    _, tcfg, jp, _ = moe_models
    own = tdec.init_model(tcfg, seed=1, device="cpu")
    shapes = jax.tree.map(lambda a: tuple(a.shape), jp)
    assert tdec._tree_map(lambda t: tuple(t.shape), own) == \
        {**shapes, "blocks": tuple(shapes["blocks"])}
    ffn = own["blocks"][0]["ffn"]
    d, f = tcfg.d_model, tcfg.moe_d_ff
    assert abs(ffn["w1"].std().item() * d ** 0.5 - 1) < 0.05
    assert abs(ffn["w2"].std().item() * f ** 0.5 - 1) < 0.05
    assert abs(ffn["router"].std().item() * d ** 0.5 - 1) < 0.1
    # layers are drawn one after another, not copies of one draw
    assert not torch.equal(ffn["w1"][0], ffn["w1"][1])
