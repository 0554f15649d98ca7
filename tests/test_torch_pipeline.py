"""The HeterPS stage pipeline of the port against the reference's: the
reference's multi-device case (``tests/test_pipeline.py``: S 4, M 8,
mb 16, d 32) on 4 gloo stages, whose forward, loss and gradients must
match the sequential port within 1e-5 and the reference's own 4-stage
run (a subprocess on 4 forced host devices, fed the same NumPy weights);
the 1-stage case in-process; R9 (4 stacked stages on a 1-wide mesh run
stage 0 alone) pinned on both packages; and the CTR example's tower on 4
gloo stages against the same tower run layer after layer."""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

from _torch_gloo import ctr_tower_worker, pipeline_worker, run_gloo
from repro.parallel import pipeline as jpipe
from repro_torch.examples import heterps_ctr_pipeline as ctr
from repro_torch.launch.mesh import close_process_group
from repro_torch.parallel.pipeline import (make_stage_mesh, pipeline_apply,
                                           pipeline_loss, stack_stage_params)
from repro_torch.tree import tree_leaves

ROOT = Path(__file__).resolve().parent.parent
S, M, MB, D = 4, 8, 16, 32


def _data(seed=0):
    rng = np.random.default_rng(seed)
    per_stage = [{"w": (rng.standard_normal((D, D)) * 0.3).astype(np.float32),
                  "b": (rng.standard_normal(D) * 0.1).astype(np.float32)}
                 for _ in range(S)]
    xs = rng.standard_normal((M, MB, D)).astype(np.float32)
    labels = rng.standard_normal((M, MB, D)).astype(np.float32)
    return per_stage, xs, labels


def _stage_fn(p, x):
    return torch.tanh(x @ p["w"] + p["b"])


def _loss_fn(y, t):
    return torch.mean((y - t) ** 2)


def _sequential(per_stage, xs, labels):
    params = stack_stage_params([{k: torch.from_numpy(v) for k, v in
                                  p.items()} for p in per_stage])
    leaves = [t.requires_grad_(True) for t in tree_leaves(params)]
    h = torch.from_numpy(xs)
    for i in range(len(per_stage)):
        h = _stage_fn({k: v[i] for k, v in params.items()}, h)
    t = torch.from_numpy(labels)
    loss = torch.stack([_loss_fn(h[m], t[m]) for m in range(M)]).mean()
    grads = torch.autograd.grad(loss, leaves)
    return h.detach().numpy(), float(loss), [g.numpy() for g in grads]


_JAX_PIPELINE = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import sys
    sys.path.insert(0, "src")
    import jax, jax.numpy as jnp, numpy as np
    from repro.parallel.pipeline import (
        make_stage_mesh, pipeline_apply, pipeline_loss, stack_stage_params)
    d = np.load(sys.argv[1])
    S = 4
    per_stage = [{"w": jnp.asarray(d[f"w{i}"]), "b": jnp.asarray(d[f"b{i}"])}
                 for i in range(S)]
    params = stack_stage_params(per_stage)
    xs, labels = jnp.asarray(d["xs"]), jnp.asarray(d["labels"])
    stage_fn = lambda p, x: jnp.tanh(x @ p["w"] + p["b"])
    lf = lambda y, t: jnp.mean((y - t) ** 2)
    mesh = make_stage_mesh(S)
    out = jax.jit(lambda prm: pipeline_apply(stage_fn, prm, xs, mesh))(params)
    loss, grads = jax.jit(jax.value_and_grad(
        lambda prm: pipeline_loss(stage_fn, lf, prm, xs, labels, mesh)))(
            params)
    np.savez(sys.argv[2], out=np.asarray(out), loss=np.asarray(loss),
             b=np.asarray(grads["b"]), w=np.asarray(grads["w"]))
""")


def _reference(tmp_path, per_stage, xs, labels):
    src = tmp_path / "in.npz"
    dst = tmp_path / "out.npz"
    np.savez(src, xs=xs, labels=labels,
             **{f"{k}{i}": v for i, p in enumerate(per_stage)
                for k, v in p.items()})
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    proc = subprocess.run([sys.executable, "-c", _JAX_PIPELINE, str(src),
                           str(dst)], cwd=ROOT, env=env, capture_output=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr.decode()
    return np.load(dst)


def test_four_stage_gloo_pipeline_matches_sequential_and_reference(tmp_path):
    per_stage, xs, labels = _data()
    want_out, want_loss, want_grads = _sequential(per_stage, xs, labels)
    ref = _reference(tmp_path, per_stage, xs, labels)
    results = run_gloo(pipeline_worker, S, per_stage, xs, labels)
    for out, loss, grads in results:
        # tree order: b, w
        np.testing.assert_allclose(out, want_out, atol=1e-5, rtol=0)
        np.testing.assert_allclose(loss, want_loss, atol=1e-5, rtol=0)
        for g, w in zip(grads, want_grads):
            np.testing.assert_allclose(g, w, atol=1e-5, rtol=0)
        np.testing.assert_allclose(out, ref["out"], atol=1e-5, rtol=0)
        np.testing.assert_allclose(loss, ref["loss"], atol=1e-5, rtol=0)
        np.testing.assert_allclose(grads[0], ref["b"], atol=1e-5, rtol=0)
        np.testing.assert_allclose(grads[1], ref["w"], atol=1e-5, rtol=0)


def test_one_stage_pipeline_in_process():
    per_stage, xs, labels = _data(seed=1)
    per_stage = per_stage[:1]
    mesh = make_stage_mesh(1, device_type="cpu", backend="gloo")
    try:
        params = stack_stage_params([{k: torch.from_numpy(v) for k, v in
                                      p.items()} for p in per_stage])
        leaves = [t.requires_grad_(True) for t in tree_leaves(params)]
        x, t = torch.from_numpy(xs), torch.from_numpy(labels)
        out = pipeline_apply(_stage_fn, params, x, mesh)
        loss = pipeline_loss(_stage_fn, _loss_fn, params, x, t, mesh)
        grads = torch.autograd.grad(loss, leaves)
    finally:
        close_process_group()
    want_out, want_loss, want_grads = _sequential(per_stage, xs, labels)
    np.testing.assert_allclose(out.detach().numpy(), want_out, atol=1e-6,
                               rtol=0)
    np.testing.assert_allclose(float(loss), want_loss, atol=1e-6, rtol=0)
    for g, w in zip(grads, want_grads):
        np.testing.assert_allclose(g.numpy(), w, atol=1e-6, rtol=0)
    assert not torch.distributed.is_initialized()


def _r9_reference(per_stage, xs, labels):
    """The reference's ``pipeline_loss`` and its gradients for the stacked
    stages on a 1-wide stage mesh (this process has one host device)."""
    params = jpipe.stack_stage_params(
        [{k: jnp.asarray(v) for k, v in p.items()} for p in per_stage])
    mesh = jpipe.make_stage_mesh(1)
    loss, grads = jax.jit(jax.value_and_grad(lambda prm: jpipe.pipeline_loss(
        lambda p, x: jnp.tanh(x @ p["w"] + p["b"]),
        lambda y, t: jnp.mean((y - t) ** 2), prm, jnp.asarray(xs),
        jnp.asarray(labels), mesh)))(params)
    return float(loss), np.asarray(grads["b"]), np.asarray(grads["w"])


def test_one_wide_mesh_runs_only_stage_0_in_both_packages_R9():
    """R9: with the stages stacked 4 deep on a 1-wide ``stage`` mesh, the
    reference's ``pipeline_apply`` takes ``a[0]`` of its one block, so
    only stage 0 runs: stages 1-3 get exactly zero gradients and the loss
    is stage 0's alone.  The port copies it (``_stage_slice``), and both
    packages agree within 1e-5."""
    per_stage, xs, labels = _data(seed=2)
    jloss, jb, jw = _r9_reference(per_stage, xs, labels)
    mesh = make_stage_mesh(1, device_type="cpu", backend="gloo")
    try:
        params = stack_stage_params([{k: torch.from_numpy(v) for k, v in
                                      p.items()} for p in per_stage])
        leaves = [t.requires_grad_(True) for t in tree_leaves(params)]
        loss = pipeline_loss(_stage_fn, _loss_fn, params,
                             torch.from_numpy(xs), torch.from_numpy(labels),
                             mesh)
        gb, gw = (g.numpy() for g in torch.autograd.grad(loss, leaves))
    finally:
        close_process_group()
    _, stage0_loss, _ = _sequential(per_stage[:1], xs, labels)
    _, full_loss, _ = _sequential(per_stage, xs, labels)
    for b, w in ((jb, jw), (gb, gw)):
        assert np.abs(w[0]).sum() > 0 and np.abs(b[0]).sum() > 0
        assert not w[1:].any() and not b[1:].any()
    np.testing.assert_allclose(loss.item(), jloss, atol=1e-5, rtol=0)
    np.testing.assert_allclose(jloss, stage0_loss, atol=1e-5, rtol=0)
    assert abs(full_loss - stage0_loss) > 1e-3
    np.testing.assert_allclose(gb, jb, atol=1e-5, rtol=0)
    np.testing.assert_allclose(gw, jw, atol=1e-5, rtol=0)


def _ctr_sequential(weights, emb, labels):
    """The CTR example's tower with its stages applied one after another
    (no mesh): the loss and the gradients in ``dense_params`` order, the
    rows' first."""
    tower = ctr.tower_from_numpy(weights, device="cpu")
    rows = torch.from_numpy(emb).requires_grad_()
    h = rows.reshape(ctr.MICRO, ctr.MB, -1) @ tower["in_proj"]
    for s in range(ctr.N_STAGES):
        h = ctr.stage_fn({"layers": [{k: v[s] for k, v in layer.items()}
                                     for layer in tower["stage_params"][
                                         "layers"]]}, h)
    y = torch.from_numpy(labels).reshape(ctr.MICRO, ctr.MB)
    loss = torch.stack([ctr.bce(h[m] @ tower["head_w"], y[m])
                        for m in range(ctr.MICRO)]).mean()
    grads = torch.autograd.grad(loss, [rows, *ctr.dense_params(tower)])
    return loss.item(), [g.numpy() for g in grads]


def test_ctr_tower_on_four_gloo_stages_runs_every_layer():
    """With one rank a stage the CTR example's tower runs all 4 stages:
    every one of the 8 layers gets a non-zero gradient, and the loss and
    every gradient equal the sequential tower's within 1e-5."""
    rng = np.random.default_rng(3)
    B = ctr.MICRO * ctr.MB
    weights = ctr.init_weights()
    emb = (rng.standard_normal((B, ctr.SLOTS, ctr.EMB_DIM)) * 0.05).astype(
        np.float32)
    labels = (rng.random(B) > 0.5).astype(np.float32)
    want_loss, want = _ctr_sequential(weights, emb, labels)
    results = run_gloo(ctr_tower_worker, ctr.N_STAGES, weights, emb, labels)
    n_layers = 0
    for leaf in want[2:-1]:
        for s in range(ctr.N_STAGES):
            assert np.abs(leaf[s]).sum() > 0
        n_layers += leaf.ndim == 3
    assert n_layers * ctr.N_STAGES == ctr.N_STAGES * ctr.LAYERS_PER_STAGE
    for loss, grads in results:
        np.testing.assert_allclose(loss, want_loss, atol=1e-5, rtol=0)
        assert len(grads) == len(want)
        for g, w in zip(grads, want):
            assert np.abs(g).sum() > 0
            np.testing.assert_allclose(g, w, atol=1e-5, rtol=1e-5)
