"""The HeterPS stage pipeline of the port against the reference's: the
reference's multi-device case (``tests/test_pipeline.py``: S 4, M 8,
mb 16, d 32) on 4 gloo stages, whose forward, loss and gradients must
match the sequential port within 1e-5 and the reference's own 4-stage
run (a subprocess on 4 forced host devices, fed the same NumPy weights);
and the 1-stage case in-process."""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import torch

from _torch_gloo import pipeline_worker, run_gloo
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
