"""The port's training slice against the JAX reference on the CPU, float32,
at reduced width: ``loss_fn`` and every gradient leaf against
``jax.value_and_grad(dec.loss_fn)`` (reduced llama3.2-1b, with and without
the chunked loss head, and reduced olmoe-1b-7b), one microbatched
``make_train_step`` step (params and AdamW state), the synthetic dataset
bit for bit, checkpoints across the two packages, ``train()`` and its CLI.
Weights are the reference's ``init_model`` tree converted through
``params_from_jax``.

Tolerances (float32, sums in another order): the loss rtol 1e-5; each
gradient leaf atol 1e-5 · max|g_ref| + rtol 1e-3 (a leaf's small entries
are differences of larger terms); after one AdamW step ``mu`` as the
gradients, ``nu`` (the squared gradient) at twice their relative error
(atol 2e-5 · max|nu_ref|, rtol 2e-3), and parameters atol
0.1·lr: the first Adam step is ``g / (|g| + eps)``, which for the few
entries with |g| near eps = 1e-8 turns a 1e-3 relative gradient
difference into a step difference of a few percent (a wrong update
moves a parameter by ~lr).
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import load_checkpoint as jload
from repro.checkpoint import save_checkpoint as jsave
from repro.configs import get_config as jget
from repro.data import SyntheticTokenDataset as JData
from repro.launch.steps import make_train_step as jmake_step
from repro.models import decoder as jdec
from repro.nn import attention as jattn
from repro.nn.base import cross_entropy_loss as jce
from repro.optim import adamw_init as jadamw_init
from repro_torch.checkpoint import load_checkpoint, save_checkpoint
from repro_torch.configs import get_config as tget
from repro_torch.data import PrefetchLoader, SyntheticTokenDataset
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.models import decoder as tdec
from repro_torch.models.convert import params_from_jax
from repro_torch.nn import attention as tattn
from repro_torch.nn.base import cross_entropy_loss
from repro_torch.optim import OptState, adamw_init
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

F32J, F32T = jnp.float32, torch.float32

_jvg = jax.jit(jax.value_and_grad(jdec.loss_fn), static_argnums=1,
               static_argnames=("compute_dtype", "remat"))


def _flat(tree, prefix=""):
    """{key path: numpy array} of a dict/tuple tree (either package)."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], f"{prefix}/{k}"))
        return out
    if isinstance(tree, (tuple, list)):
        out = {}
        for i, t in enumerate(tree):
            out.update(_flat(t, f"{prefix}/{i}"))
        return out
    if isinstance(tree, torch.Tensor):
        return {prefix: tree.detach().numpy()}
    return {prefix: np.asarray(tree)}


def _models(arch):
    jcfg = jget(arch, reduced=True)
    tcfg = tget(arch, reduced=True)
    jp = jdec.init_model(jcfg, jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    return jcfg, tcfg, jp, tp


@pytest.fixture(scope="module", params=["llama3.2-1b", "olmoe-1b-7b"])
def models(request):
    return _models(request.param)


def _batch(B, S, vocab, seed=0):
    ds = JData(vocab, B, S, seed=seed)
    return ds.batch(0)


def _port_value_and_grad(tp, tcfg, batch, **kw):
    leaves = [t.detach().clone().requires_grad_(True)
              for t in tree_leaves(tp)]
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss = tdec.loss_fn(tree_unflatten(tp, leaves), tcfg, tb,
                        compute_dtype=F32T, **kw)
    grads = torch.autograd.grad(loss, leaves)
    return loss.item(), tree_unflatten(tp, list(grads))


def _assert_grads_close(tg, jg, *, rtol=1e-3):
    got, want = _flat(tg), _flat(jax.tree.map(np.asarray, jg))
    assert got.keys() == want.keys()
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=rtol,
                                   atol=1e-5 * np.abs(w).max() + 1e-12,
                                   err_msg=k)


def test_cross_entropy_loss_matches_reference():
    r = np.random.default_rng(0)
    logits = r.standard_normal((2, 5, 40)).astype(np.float32) * 3
    labels = r.integers(-1, 40, (2, 5)).astype(np.int32)
    want = float(jce(jnp.asarray(logits), jnp.asarray(labels), vocab=40))
    got = cross_entropy_loss(torch.from_numpy(logits),
                             torch.from_numpy(labels), vocab=40).item()
    assert abs(got - want) <= 1e-6 * abs(want)
    none = cross_entropy_loss(torch.from_numpy(logits),
                              torch.full((2, 5), -1), vocab=40)
    assert none.item() == 0.0


@pytest.mark.parametrize("arch", ["llama3.2-1b", "olmoe-1b-7b"])
def test_attention_and_its_gradients_match_reference(arch):
    """The kernel-holding module's full-sequence attention (GQA / qk-norm,
    rope) and its input and weight gradients, through the plain flash
    path, against the reference's jnp attention."""
    jcfg, tcfg, jp, tp = _models(arch)
    spec = tdec._attn_spec(tcfg, tcfg.pattern[0])
    jspec = jdec._attn_spec(jcfg, jcfg.pattern[0])
    B, S, D = 2, 40, tcfg.d_model
    r = np.random.default_rng(3)
    x = r.standard_normal((B, S, D)).astype(np.float32)
    g = r.standard_normal((B, S, D)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
    jmix = jax.tree.map(lambda a: a[0], jp["blocks"][0]["mixer"])

    def jf(p, x):
        return jnp.sum(jattn.attention(p, x, jspec,
                                       positions=jnp.asarray(pos)) * g)

    jval, (jgp, jgx) = jax.value_and_grad(jf, argnums=(0, 1))(
        jmix, jnp.asarray(x))
    tmix = {k: v[0].clone().requires_grad_(True)
            for k, v in tp["blocks"][0]["mixer"].items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    out = tattn.attention(tmix, tx, spec,
                          positions=torch.from_numpy(pos.copy()))
    val = (out * torch.from_numpy(g)).sum()
    grads = torch.autograd.grad(val, [tx, *tmix.values()])
    assert abs(val.item() - float(jval)) <= 1e-4 * abs(float(jval)) + 1e-3
    np.testing.assert_allclose(grads[0].numpy(), np.asarray(jgx), atol=1e-4,
                               rtol=1e-4)
    for (k, _), gt in zip(tmix.items(), grads[1:]):
        np.testing.assert_allclose(gt.numpy(), np.asarray(jgp[k]),
                                   atol=1e-4, rtol=1e-3, err_msg=k)


def test_loss_and_every_gradient_match_reference(models):
    jcfg, tcfg, jp, tp = models
    batch = _batch(2, 48, tcfg.vocab, seed=1)
    jloss, jg = _jvg(jp, jcfg, {k: jnp.asarray(v) for k, v in batch.items()},
                     compute_dtype=F32J, remat=True)
    loss, tg = _port_value_and_grad(tp, tcfg, batch, remat=True)
    assert abs(loss - float(jloss)) <= 1e-5 * abs(float(jloss))
    _assert_grads_close(tg, jg)


def test_chunked_loss_head_matches_reference():
    """S = 1024 > LOSS_CHUNK: the head runs over two checkpointed
    512-position chunks on both sides; no remat of the layers."""
    jcfg, tcfg, jp, tp = _models("llama3.2-1b")
    batch = _batch(1, 1024, tcfg.vocab, seed=2)
    batch["labels"][0, :7] = -1                 # ignored positions
    jloss, jg = _jvg(jp, jcfg, {k: jnp.asarray(v) for k, v in batch.items()},
                     compute_dtype=F32J, remat=False)
    loss, tg = _port_value_and_grad(tp, tcfg, batch, remat=False)
    assert abs(loss - float(jloss)) <= 1e-5 * abs(float(jloss))
    _assert_grads_close(tg, jg)


def test_forward_logits_match_reference():
    jcfg, tcfg, jp, tp = _models("olmoe-1b-7b")
    toks = _batch(2, 24, tcfg.vocab)["tokens"]
    jl, jaux = jdec.forward(jp, jcfg, jnp.asarray(toks), compute_dtype=F32J)
    with torch.no_grad():
        tl, taux = tdec.forward(tp, tcfg, torch.from_numpy(toks),
                                compute_dtype=F32T)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                               rtol=1e-4)
    assert abs(taux.item() - float(jaux)) <= 1e-5


def _opt_flat(state, *, jax_state):
    if jax_state:
        return (_flat(jax.tree.map(np.asarray, state.mu)),
                _flat(jax.tree.map(np.asarray, state.nu)),
                int(state.count))
    return _flat(state.mu), _flat(state.nu), int(state.count)


@pytest.mark.parametrize("arch", ["llama3.2-1b", "olmoe-1b-7b"])
def test_microbatched_train_step_matches_reference(arch):
    """B = 4 split into 2 microbatches of 2: parameters, mu, nu and count
    after one step; the loss and grad norm."""
    jcfg, tcfg, jp, tp = _models(arch)
    batch = _batch(4, 32, tcfg.vocab, seed=4)
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
    got_p, want_p = _flat(tp2), _flat(jax.tree.map(np.asarray, jp2))
    for k, w in want_p.items():
        np.testing.assert_allclose(got_p[k], w, atol=0.1 * 3e-4, rtol=0,
                                   err_msg=k)
    (tmu, tnu, tc), (jmu, jnu, jc) = (_opt_flat(topt, jax_state=False),
                                      _opt_flat(jopt, jax_state=True))
    assert tc == jc == 1
    for k in jmu:
        np.testing.assert_allclose(tmu[k], jmu[k], rtol=1e-3,
                                   atol=1e-5 * np.abs(jmu[k]).max() + 1e-12,
                                   err_msg=f"mu {k}")
        np.testing.assert_allclose(tnu[k], jnu[k], rtol=2e-3,
                                   atol=2e-5 * np.abs(jnu[k]).max() + 1e-20,
                                   err_msg=f"nu {k}")


def test_microbatch_split_rule_and_accumulation():
    """The reference's split rule: microbatch 3 does not divide B = 4, so
    the batch runs whole; microbatch 1 gives 4 microbatches whose
    averaged gradients equal the whole batch's (the loss is a per-token
    mean over equal-sized microbatches)."""
    _, tcfg, _, tp = _models("llama3.2-1b")
    batch = {k: torch.from_numpy(v)
             for k, v in _batch(4, 16, tcfg.vocab, seed=6).items()}
    outs = {}
    for m in (None, 1, 3):
        p = tree_map(torch.clone, tp)
        step = tsteps.make_train_step(tcfg, compute_dtype=F32T, microbatch=m,
                                      lr=1e-3)
        p, _, met = step(p, adamw_init(p), batch)
        outs[m] = (p, met)
    for m in (1, 3):
        assert abs(outs[m][1]["loss"].item()
                   - outs[None][1]["loss"].item()) < 1e-5
        for a, b in zip(tree_leaves(outs[m][0]), tree_leaves(outs[None][0])):
            torch.testing.assert_close(a, b, atol=0.1 * 1e-3, rtol=0)


def test_synthetic_batches_equal_the_reference_bit_for_bit():
    for kw in ({"seed": 0}, {"seed": 7, "zipf_a": 0}, {"seed": 3,
                                                        "zipf_a": 1.5}):
        a = SyntheticTokenDataset(1024, 4, 33, **kw)
        b = JData(1024, 4, 33, **kw)
        for step in (0, 1, 17):
            ba, bb = a.batch(step), b.batch(step)
            assert ba.keys() == bb.keys()
            for k in ba:
                assert ba[k].dtype == bb[k].dtype
                np.testing.assert_array_equal(ba[k], bb[k])
    ctx = SyntheticTokenDataset(50, 2, 8, context_len=3, d_model=4).batch(2)
    np.testing.assert_array_equal(
        ctx["context"],
        JData(50, 2, 8, context_len=3, d_model=4).batch(2)["context"])


def test_prefetch_loader_streams_and_closes():
    ds = SyntheticTokenDataset(64, 2, 4)
    loader = PrefetchLoader(ds, depth=2)
    try:
        for i in range(3):
            np.testing.assert_array_equal(next(loader)["tokens"],
                                          ds.batch(i)["tokens"])
    finally:
        loader.close()
    assert not loader._t.is_alive()
    finite = PrefetchLoader([1, 2], depth=1)
    assert list(finite) == [1, 2]
    finite.close()


def _small_state():
    jcfg, tcfg, jp, tp = _models("olmoe-1b-7b")
    topt = adamw_init(tp)
    r = np.random.default_rng(8)
    topt = OptState(mu=tree_map(lambda t: torch.from_numpy(
        r.standard_normal(tuple(t.shape)).astype(np.float32)), topt.mu),
        nu=tree_map(torch.rand_like, topt.nu),
        count=torch.tensor(5, dtype=torch.int32))
    return jcfg, tcfg, jp, tp, topt


def test_port_checkpoint_loads_in_the_reference(tmp_path):
    jcfg, tcfg, jp, tp, topt = _small_state()
    path = str(tmp_path / "ck")
    nbytes = save_checkpoint(path, params=tp, opt_state=topt, step=9,
                             metadata={"arch": tcfg.name},
                             extra_arrays={"cursor": np.arange(3)})
    assert nbytes > 0
    jp2, jopt2, step = jload(path, params_template=jp,
                             opt_template=jadamw_init(jp))
    assert step == 9 and int(jopt2.count) == 5
    for ref, got in ((tp, jp2), (topt.mu, jopt2.mu), (topt.nu, jopt2.nu)):
        a, b = _flat(ref), _flat(jax.tree.map(np.asarray, got))
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


def test_reference_checkpoint_loads_in_the_port(tmp_path):
    jcfg, tcfg, jp, tp, topt = _small_state()
    jopt = jadamw_init(jp)
    jopt = type(jopt)(mu=jax.tree.map(lambda a: a + 1.5, jopt.mu),
                      nu=jopt.nu, count=jnp.asarray(3, jnp.int32))
    path = str(tmp_path / "ck")
    jsave(path, params=jp, opt_state=jopt, step=4)
    tp2, topt2, step = load_checkpoint(path, params_template=tp,
                                       opt_template=adamw_init(tp))
    assert step == 4 and int(topt2.count) == 3
    assert topt2.count.dtype == torch.int32
    for got, ref in ((tp2, jp), (topt2.mu, jopt.mu)):
        a, b = _flat(got), _flat(jax.tree.map(np.asarray, ref))
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    with pytest.raises(ValueError, match="template"):
        bad = dict(tp, embed=torch.zeros(3, 3))
        load_checkpoint(path, params_template=bad)


def test_checkpoint_pointer_round_trip(tmp_path):
    from repro_torch.checkpoint import (load_extra_arrays, load_manifest,
                                        read_pointer, write_pointer)
    _, tcfg, _, tp = _models("llama3.2-1b")
    root = tmp_path / "run"
    save_checkpoint(str(root / "step_2"), params=tp, step=2,
                    extra_arrays={"x": np.ones(2)})
    assert read_pointer(str(root)) is None
    write_pointer(str(root), "step_2")
    path = read_pointer(str(root))
    assert path.endswith("step_2") and load_manifest(path)["step"] == 2
    np.testing.assert_array_equal(load_extra_arrays(path)["x"], np.ones(2))


def test_moe_train_loss_drops_ten_percent():
    """Reduced OLMoE on the plain path: ≥10% loss drop in 12 steps, the
    reference's ``tests/test_train_regression.py`` pin."""
    s = ttrain.train("olmoe-1b-7b", reduced=True, steps=12, batch=4, seq=32,
                     log_every=0, device="cpu")
    assert s["loss_decreased"], s
    assert s["last_loss"] < 0.9 * s["first_loss"], s
    assert s["devices"] == ["cpu"] and len(s["grad_norms"]) == 12
    assert all(np.isfinite(s["losses"])) and all(np.isfinite(s["grad_norms"]))


def test_train_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ttrain.train("llama3.2-1b", steps=1)


def test_train_cli_on_cpu(tmp_path, capsys, monkeypatch):
    from repro_torch import obs

    ck, od = tmp_path / "ck", tmp_path / "obs"
    monkeypatch.setenv("REPRO_OBS", "0")       # restored after the test
    try:
        ttrain.main(["--device", "cpu", "--steps", "2", "--batch", "2",
                     "--seq", "16", "--checkpoint-dir", str(ck),
                     "--obs-dir", str(od)])
    finally:
        obs.configure(enabled=False)
        obs.REGISTRY.reset()
        obs.BUFFER.drain()
    out = capsys.readouterr().out
    summary = json.loads(out[out.index("{"):])
    assert summary["arch"] == "llama3.2-1b-reduced" and summary["steps"] == 2
    assert (ck / "manifest.json").exists() and (od / "trace.json").exists()
    trace = json.loads((od / "trace.json").read_text())
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    assert sum(e.get("name") == "train.step" for e in events) == 2


def test_tree_helpers_round_trip():
    tree = {"b": (torch.ones(2), torch.zeros(1)), "a": torch.full((3,), 2.0)}
    leaves = tree_leaves(tree)
    assert [t.shape[0] for t in leaves] == [3, 2, 1]    # sorted keys
    back = tree_unflatten(tree, leaves)
    assert back["b"][0] is leaves[1] and isinstance(back["b"], tuple)
    doubled = tree_map(lambda x, y: x + y, tree, tree)
    assert torch.equal(doubled["a"], torch.full((3,), 4.0))
    with pytest.raises(ValueError):
        tree_unflatten(tree, leaves + [torch.ones(1)])


def test_prefill_and_serve_steps_match_forward():
    _, tcfg, _, tp = _models("llama3.2-1b")
    toks = torch.from_numpy(_batch(1, 12, tcfg.vocab)["tokens"])
    logits = tsteps.make_prefill_step(tcfg, compute_dtype=F32T)(
        tp, {"tokens": toks})
    with torch.no_grad():
        want, _ = tdec.forward(tp, tcfg, toks, compute_dtype=F32T,
                               remat=False)
    torch.testing.assert_close(logits, want, atol=0, rtol=0)
    cfg = dataclasses.replace(tcfg, kv_impl="dense")
    cache = tdec.init_cache(cfg, 1, 16, dtype=F32T, device="cpu")
    lg, _ = tsteps.make_serve_step(cfg, compute_dtype=F32T)(
        tp, toks[:, :1], cache, 0)
    torch.testing.assert_close(lg[0, 0], logits[0, 0], atol=1e-4, rtol=1e-4)
