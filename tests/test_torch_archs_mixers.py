"""The recurrent, hybrid, vision and audio archs — rwkv6-7b (RWKV-6 time-
and channel-mix), jamba-v0.1-52b (Mamba + attention + MoE),
llama-3.2-vision-11b (cross-attention layers over 64 stub patches) and
whisper-large-v3 (a 2-layer bidirectional encoder over 64 stub frames,
``attn+cross`` decoder layers, learned positions, LayerNorm, tied
embeddings) — against the JAX reference at reduced width, float32 on the
CPU, with the reference's ``init_model`` weights converted through
``params_from_jax``.

``forward``, ``loss_fn`` and every gradient leaf take the stub context.
The reference's training path masks cross-attention causally by position
(ROADMAP.md R7); the port does not copy it, so for the cross archs the
reference runs with ``repro.nn.attention.attention`` patched to
``causal=False`` whenever ``kv_x`` is given, and one test pins R7 itself.
The serving paths are test_torch_archs_mixers_decode.py's and
test_torch_archs_mixers_serve.py's.

Tolerances: logits rtol/atol 1e-4 (the scans round in another order
than ``lax.scan`` / ``associative_scan``; they agree to ~1e-5), the loss
rtol 1e-5, each gradient leaf atol 1e-5 · max|g_ref| + rtol 1e-3 (as
test_torch_archs_train.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.models import decoder as jdec
from repro.nn import attention as jattn
from repro_torch.configs import get_config as tget
from repro_torch.models import decoder as tdec
from repro_torch.models.convert import params_from_jax
from repro_torch.tree import tree_leaves, tree_unflatten

ARCHS = ("rwkv6-7b", "jamba-v0.1-52b", "llama-3.2-vision-11b",
         "whisper-large-v3")
CROSS_ARCHS = ("llama-3.2-vision-11b", "whisper-large-v3")
TOL = dict(rtol=1e-4, atol=1e-4)
F32J, F32T = jnp.float32, torch.float32


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


def _context(cfg, B, seed=0):
    """The stub frontend's embeddings (B, N, d_model), or None."""
    n = cfg.encoder.frames if cfg.encoder else cfg.cross_kv_len
    if not n:
        return None
    return np.random.default_rng(seed).standard_normal(
        (B, n, cfg.d_model)).astype(np.float32)


def _tokens(B, S, vocab, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (B, S)).astype(
        np.int32)


@pytest.fixture
def noncausal_reference_cross(monkeypatch):
    """The reference's ``attention`` with ``causal=False`` whenever it is
    given a cross-attention source (the R7 repair, on the reference's
    side only for these tests)."""
    orig = jattn.attention

    def attention(p, x, spec, *, positions, kv_x=None, kv_positions=None):
        if kv_x is not None:
            spec = dataclasses.replace(spec, causal=False)
        return orig(p, x, spec, positions=positions, kv_x=kv_x,
                    kv_positions=kv_positions)

    monkeypatch.setattr(jattn, "attention", attention)


def _flat(tree, prefix=""):
    """{key path: numpy array} of a dict/tuple tree (either package)."""
    if isinstance(tree, dict):
        return {k2: v for k in sorted(tree)
                for k2, v in _flat(tree[k], f"{prefix}/{k}").items()}
    if isinstance(tree, (tuple, list)):
        return {k2: v for i, t in enumerate(tree)
                for k2, v in _flat(t, f"{prefix}/{i}").items()}
    if isinstance(tree, torch.Tensor):
        return {prefix: tree.detach().float().numpy()}
    return {prefix: np.asarray(tree, np.float32)}


def _batch(cfg, B, S, seed):
    toks = _tokens(B, S + 1, cfg.vocab, seed)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    ctx = _context(cfg, B, seed)
    if ctx is not None:
        batch["context"] = ctx
    return batch


def test_forward_loss_and_every_gradient_match_reference(
        models, noncausal_reference_cross):
    """2 x 24 tokens with remat on both sides: logits, the loss (with the
    MoE aux loss for jamba) and every gradient leaf, the encoder's and the
    learned positions' included."""
    jcfg, tcfg, jp, tp = models
    batch = _batch(tcfg, 2, 24, seed=1)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    jl, _ = jax.jit(lambda p, b: jdec.forward(
        p, jcfg, b["tokens"], context=b.get("context"),
        compute_dtype=F32J))(jp, jb)
    with torch.no_grad():
        tl, _ = tdec.forward(tp, tcfg, tb["tokens"],
                             context=tb.get("context"), compute_dtype=F32T)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)

    jloss, jg = jax.jit(jax.value_and_grad(lambda p, b: jdec.loss_fn(
        p, jcfg, b, compute_dtype=F32J, remat=True)))(jp, jb)
    leaves = [t.detach().clone().requires_grad_(True)
              for t in tree_leaves(tp)]
    tparams = tree_unflatten(tp, leaves)
    loss = tdec.loss_fn(tparams, tcfg, tb, compute_dtype=F32T, remat=True)
    tg = tree_unflatten(tp, list(torch.autograd.grad(loss, leaves)))
    assert abs(loss.item() - float(jloss)) <= 1e-5 * abs(float(jloss))
    got, want = _flat(tg), _flat(jg)
    assert got.keys() == want.keys()
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=1e-3,
                                   atol=1e-5 * np.abs(w).max() + 1e-12,
                                   err_msg=k)


@pytest.mark.parametrize("arch", CROSS_ARCHS)
def test_reference_training_cross_attention_is_causal_R7(arch):
    """R7: the reference's ``forward`` masks context frame j from query t
    when j > t, unlike its own prefill and cross decode; the port attends
    every frame on every path.  Unpatched, the reference's logits differ
    from the port's by far more than rounding; the port equals the
    reference patched to non-causal cross-attention (the test above)."""
    jcfg, tcfg, jp, tp = _models(arch)
    toks, ctx = _tokens(2, 24, jcfg.vocab, 2), _context(jcfg, 2, 2)
    jl, _ = jax.jit(lambda p, t, c: jdec.forward(
        p, jcfg, t, context=c, compute_dtype=F32J))(
        jp, jnp.asarray(toks), jnp.asarray(ctx))
    with torch.no_grad():
        tl, _ = tdec.forward(tp, tcfg, torch.from_numpy(toks),
                             context=torch.from_numpy(ctx),
                             compute_dtype=F32T)
    assert np.abs(tl.numpy() - np.asarray(jl)).max() > 1e-2


def test_init_model_draws_the_reference_tree(models):
    """The port's own init draws the reference's tree: the encoder, the
    learned positions and each mixer's leaves, at the same shapes."""
    _, tcfg, jp, _ = models
    own = tdec.init_model(tcfg, seed=1, device="cpu")
    shapes = jax.tree.map(lambda a: tuple(a.shape), jp)
    assert tdec._tree_map(lambda t: tuple(t.shape), own) == \
        {**shapes, "blocks": tuple(shapes["blocks"])}
