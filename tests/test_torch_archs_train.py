"""Training of chatglm3-6b, gemma2-2b and internlm2-20b against the JAX
reference at reduced width, float32 on the CPU: ``loss_fn`` and every
gradient leaf against ``jax.value_and_grad``, one microbatched
``make_train_step`` step, and the train CLI.  Tolerances are
test_torch_train.py's: the loss rtol 1e-5, each gradient leaf atol
1e-5 · max|g_ref| + rtol 1e-3, after one AdamW step parameters atol
0.1 · lr, ``mu`` as the gradients and ``nu`` at twice their relative
error.
"""

import dataclasses
import json

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
from repro_torch.launch import train as ttrain
from repro_torch.models import decoder as tdec
from repro_torch.models.convert import params_from_jax
from repro_torch.optim import adamw_init
from repro_torch.tree import tree_leaves, tree_unflatten

ARCHS = ("chatglm3-6b", "gemma2-2b", "internlm2-20b")
F32J, F32T = jnp.float32, torch.float32

_jvg = jax.jit(jax.value_and_grad(jdec.loss_fn), static_argnums=1,
               static_argnames=("compute_dtype", "remat"))


def _models(arch, **over):
    jcfg = dataclasses.replace(jget(arch, reduced=True), **over)
    tcfg = dataclasses.replace(tget(arch, reduced=True), **over)
    jp = jdec.init_model(jcfg, jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    return jcfg, tcfg, jp, tp


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


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """The reduced models' ops are small; with the suite's other workers
    on the same cores, intra-op threads only contend, so hold this
    module's tests to one."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port_value_and_grad(tp, tcfg, batch, **kw):
    leaves = [t.detach().clone().requires_grad_(True)
              for t in tree_leaves(tp)]
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss = tdec.loss_fn(tree_unflatten(tp, leaves), tcfg, tb, **kw)
    grads = torch.autograd.grad(loss, leaves)
    return loss.item(), tree_unflatten(tp, list(grads))


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_every_gradient_match_reference(arch):
    """2 x 48 tokens (past gemma2's window), remat on both sides."""
    jcfg, tcfg, jp, tp = _models(arch)
    batch = JData(tcfg.vocab, 2, 48, seed=1).batch(0)
    jloss, jg = _jvg(jp, jcfg, {k: jnp.asarray(v) for k, v in batch.items()},
                     compute_dtype=F32J, remat=True)
    loss, tg = _port_value_and_grad(tp, tcfg, batch, compute_dtype=F32T,
                                    remat=True)
    assert abs(loss - float(jloss)) <= 1e-5 * abs(float(jloss))
    got, want = _flat(tg), _flat(jg)
    assert got.keys() == want.keys()
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=1e-3,
                                   atol=1e-5 * np.abs(w).max() + 1e-12,
                                   err_msg=k)


@pytest.mark.parametrize("arch", ARCHS)
def test_microbatched_train_step_matches_reference(arch):
    """B = 4 in 2 microbatches of 2, 40 tokens: parameters, moments and
    count after one step, the loss and the grad norm.

    The first AdamW step moves an entry by lr · g / (|g| + eps) (plus
    weight decay): where the reference's |g| ≥ 1e-5 (1,000 eps) a
    gradient within its tolerance moves it by < 1e-3 · lr, held at
    0.1 · lr; below that the step turns on how the gradient's last bits
    cancel, and is held only to its size: |u| ≤ 1 on both sides and the
    decay is the same, so the two steps are at most 2 · lr apart."""
    jcfg, tcfg, jp, tp = _models(arch)
    batch = JData(tcfg.vocab, 4, 40, seed=4).batch(0)
    jstep = jax.jit(jmake_step(jcfg, compute_dtype=F32J, microbatch=2))
    jp2, jopt, jm = jstep(jp, jadamw_init(jp),
                          {k: jnp.asarray(v) for k, v in batch.items()})
    tstep = tsteps.make_train_step(tcfg, compute_dtype=F32T, microbatch=2)
    tp2, topt, tm = tstep(tp, adamw_init(tp),
                          {k: torch.from_numpy(v) for k, v in batch.items()})
    assert abs(tm["loss"].item() - float(jm["loss"])) <= 1e-5 * abs(
        float(jm["loss"]))
    assert abs(tm["grad_norm"].item() - float(jm["grad_norm"])) <= 1e-4 * abs(
        float(jm["grad_norm"]))
    got, want = _flat(tp2), _flat(jp2)
    g_ref = {k: np.abs(m) / 0.1 for k, m in _flat(jopt.mu).items()}
    for k, w in want.items():
        atol = np.where(g_ref[k] >= 1e-5, 0.1 * 3e-4, 2 * 3e-4)
        assert np.all(np.abs(got[k] - w) <= atol), k
    assert int(topt.count) == int(jopt.count) == 1
    for name, tol in (("mu", (1e-3, 1e-5)), ("nu", (2e-3, 2e-5))):
        got, want = _flat(getattr(topt, name)), _flat(getattr(jopt, name))
        for k, w in want.items():
            np.testing.assert_allclose(got[k], w, rtol=tol[0],
                                       atol=tol[1] * np.abs(w).max() + 1e-20,
                                       err_msg=f"{name} {k}")


@pytest.mark.parametrize("arch", ARCHS)
def test_train_cli_trains_the_arch_on_cpu(arch, capsys):
    ttrain.main(["--arch", arch, "--device", "cpu", "--steps", "2",
                 "--batch", "2", "--seq", "40"])
    out = capsys.readouterr().out
    summary = json.loads(out[out.index("{"):])
    assert summary["arch"] == f"{arch}-reduced" and summary["steps"] == 2
    assert summary["devices"] == ["cpu"]
    assert all(np.isfinite(summary["losses"] + summary["grad_norms"]))
