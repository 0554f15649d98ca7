"""bfloat16 on both sides: reduced internlm2-20b and qwen3-moe-30b-a3b,
the reference's ``init_model(dtype=bfloat16)`` weights converted for the
port, bfloat16 compute and caches, on the CPU.  The two packages round
sums taken in another order, so nothing here is bitwise.  Tolerances, in
units of bfloat16's 8-bit significand (one ulp is 2^-7 of the power of
two at or below a value):

* logits within 4 ulps of the reference's largest |logit| of the call
  (measured: under 2);
* the greedy token equal wherever the reference's top-2 margin is wider
  than twice that tolerance (elsewhere two tokens are tied within it);
* the loss within 1e-3 relative (it is a float32 reduction of bfloat16
  logits; measured: 2e-4);
* each gradient leaf within 2^-5 of its Frobenius norm (4 ulps relative)
  and each entry within 2^-4 of the leaf's largest |g| (measured: under
  2% and 2.2%);
* after one AdamW step (bfloat16 moments, as the reference keeps them)
  the loss as above, the grad norm within 2^-5 relative, and each
  parameter within 2 · lr plus one ulp (of the larger of the two) of
  the reference's: the first
  step moves an entry by lr · g / (|g| + eps), so a gradient entry
  whose sign the roundings flip moves it by up to 2 · lr the other way.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.data import SyntheticTokenDataset as JData
from repro.launch.steps import make_train_step as jmake_step
from repro.models import decoder as jdec
from repro.optim import adamw_init as jadamw_init
from repro_torch.configs import get_config as tget
from repro_torch.launch import steps as tsteps
from repro_torch.models import decoder as tdec
from repro_torch.models.convert import params_from_jax
from repro_torch.optim import adamw_init
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

ARCHS = ("internlm2-20b", "qwen3-moe-30b-a3b")
BJ, BT = jnp.bfloat16, torch.bfloat16

_jprefill = jax.jit(jdec.prefill, static_argnums=1,
                    static_argnames="compute_dtype")
_jstep = jax.jit(jdec.decode_step, static_argnums=1,
                 static_argnames="compute_dtype")
_jvg = jax.jit(jax.value_and_grad(jdec.loss_fn), static_argnums=1,
               static_argnames=("compute_dtype", "remat"))


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """Small ops beside the suite's other workers: one intra-op thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=ARCHS)
def models(request):
    jcfg = dataclasses.replace(jget(request.param, reduced=True),
                               kv_impl="paged")
    tcfg = dataclasses.replace(tget(request.param, reduced=True),
                               kv_impl="paged")
    jp = jdec.init_model(jcfg, jax.random.PRNGKey(0), dtype=BJ)
    tp = params_from_jax(jax.tree.map(
        lambda a: np.asarray(a.astype(jnp.float32)), jp), tcfg, device="cpu")
    return jcfg, tcfg, jp, tree_map(lambda t: t.to(BT), tp)


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _ulp(x: float) -> float:
    """One bfloat16 ulp at |x|."""
    return 2.0 ** (np.floor(np.log2(abs(x))) - 7)


def _hold_logits(got, want, vocab, what):
    """got/want (B, S, V'): within 4 ulps of max|want|; the greedy token
    equal where the reference's top-2 margin exceeds twice that."""
    tol = 4 * _ulp(np.abs(want).max())
    err = np.abs(got - want).max()
    assert err <= tol, f"{what}: max|dlogit| {err} > {tol}"
    top2 = np.sort(want[..., :vocab], axis=-1)[..., -2:]
    decided = top2[..., 1] - top2[..., 0] > 2 * tol
    assert np.array_equal(got[..., :vocab].argmax(-1)[decided],
                          want[..., :vocab].argmax(-1)[decided]), what


def test_prefill_and_decode_steps_within_tolerance(models):
    jcfg, tcfg, jp, tp = models
    B, S = 3, 21
    toks = np.random.default_rng(7).integers(0, jcfg.vocab, (B, S)).astype(
        np.int32)
    lengths = np.asarray([21, 12, 3], np.int32)
    jc = jdec.init_cache(jcfg, B, 48, dtype=BJ, page_size=8)
    tc = tdec.init_cache(tcfg, B, 48, dtype=BT, page_size=8, device="cpu")
    jl, jc = _jprefill(jp, jcfg, jnp.asarray(toks), jc,
                       lengths=jnp.asarray(lengths), compute_dtype=BJ)
    tl, tc = tdec.prefill(tp, tcfg, torch.from_numpy(toks), tc,
                          lengths=torch.from_numpy(lengths),
                          compute_dtype=BT)
    assert tl.dtype == torch.bfloat16 and tc["layers"][0]["kp"].dtype == BT
    jl, tl = _f32(jl), _f32(tl)
    for b, n in enumerate(lengths):
        _hold_logits(tl[b, :n], jl[b, :n], jcfg.vocab, f"prefill row {b}")
    tok = np.stack([jl[b, n - 1, :jcfg.vocab].argmax()
                    for b, n in enumerate(lengths)]).astype(np.int32)[:, None]
    for i in range(8):          # teacher-forced by the reference's tokens
        jl, jc = _jstep(jp, jcfg, jnp.asarray(tok), jc, 0, compute_dtype=BJ)
        tl, tc = tdec.decode_step(tp, tcfg, torch.from_numpy(tok), tc,
                                  compute_dtype=BT)
        jl, tl = _f32(jl), _f32(tl)
        _hold_logits(tl, jl, jcfg.vocab, f"decode step {i}")
        tok = jl[:, :, :jcfg.vocab].argmax(-1).astype(np.int32)


def test_loss_and_gradients_within_tolerance(models):
    jcfg, tcfg, jp, tp = models
    batch = JData(tcfg.vocab, 2, 48, seed=1).batch(0)
    jloss, jg = _jvg(jp, jcfg, {k: jnp.asarray(v) for k, v in batch.items()},
                     compute_dtype=BJ, remat=True)
    leaves = [t.detach().clone().requires_grad_(True)
              for t in tree_leaves(tp)]
    loss = tdec.loss_fn(tree_unflatten(tp, leaves), tcfg,
                        {k: torch.from_numpy(v) for k, v in batch.items()},
                        compute_dtype=BT)
    grads = torch.autograd.grad(loss, leaves)
    assert abs(loss.item() - float(jloss)) <= 1e-3 * abs(float(jloss))
    jleaves = jax.tree_util.tree_leaves_with_path(jg)
    assert len(jleaves) == len(grads)
    assert {g.dtype for g in grads} == {BT}
    for (path, w), g in zip(jleaves, grads):
        w, g = _f32(w), _f32(g).reshape(w.shape)
        what = jax.tree_util.keystr(path)
        assert np.linalg.norm(g - w) <= 2 ** -5 * np.linalg.norm(w), what
        assert np.abs(g - w).max() <= 2 ** -4 * np.abs(w).max(), what


def test_bf16_train_state_keeps_the_reference_dtypes():
    """``init_train_state(dtype=bfloat16)``: bfloat16 parameters and
    AdamW moments (the reference's ``zeros_like``), and one step keeps
    them so with a finite loss."""
    cfg = tget("qwen3-moe-30b-a3b", reduced=True)
    params, opt = tsteps.init_train_state(cfg, device="cpu", dtype=BT)
    assert {t.dtype for t in tree_leaves(params) + tree_leaves(opt.mu)
            + tree_leaves(opt.nu)} == {BT}
    batch = {k: torch.from_numpy(v)
             for k, v in JData(cfg.vocab, 2, 16, seed=0).batch(0).items()}
    step = tsteps.make_train_step(cfg, compute_dtype=BT, microbatch=None)
    params, opt, m = step(params, opt, batch)
    assert np.isfinite(m["loss"].item()) and np.isfinite(m["grad_norm"].item())
    assert {t.dtype for t in tree_leaves(params) + tree_leaves(opt.mu)} == {BT}


def test_bf16_train_step_matches_reference(models):
    """One ``make_train_step`` step in bfloat16 on both sides (B 4, 48
    tokens, one microbatch), from the same bfloat16 weights."""
    jcfg, tcfg, jp, tp = models
    lr = 3e-4
    batch = JData(tcfg.vocab, 4, 48, seed=2).batch(0)
    jstep = jax.jit(jmake_step(jcfg, lr=lr, compute_dtype=BJ,
                               microbatch=None))
    jp2, jopt, jm = jstep(jp, jadamw_init(jp),
                          {k: jnp.asarray(v) for k, v in batch.items()})
    tstep = tsteps.make_train_step(tcfg, lr=lr, compute_dtype=BT,
                                   microbatch=None)
    tp2, topt, tm = tstep(tree_map(torch.clone, tp), adamw_init(tp),
                          {k: torch.from_numpy(v) for k, v in batch.items()})
    assert abs(tm["loss"].item() - float(jm["loss"])) <= 1e-3 * abs(
        float(jm["loss"]))
    assert abs(tm["grad_norm"].item() - float(jm["grad_norm"])) <= \
        2 ** -5 * float(jm["grad_norm"])
    assert {t.dtype for t in tree_leaves(tp2) + tree_leaves(topt.mu)} == {BT}
    jleaves = jax.tree_util.tree_leaves_with_path(jp2)
    for (path, w), g in zip(jleaves, tree_leaves(tp2)):
        w, g = _f32(w), _f32(g).reshape(w.shape)
        top = np.maximum(np.maximum(np.abs(w), np.abs(g)), 1e-30)
        ulp = 2.0 ** (np.floor(np.log2(top)) - 7)   # each side rounds half
        assert np.all(np.abs(g - w) <= 2 * lr + ulp), \
            jax.tree_util.keystr(path)
