"""The training loss on a 2×2 (data, model) mesh: reduced llama3.2-1b and
reduced olmoe-1b-7b run ``loss_fn`` and every gradient on 4 gloo ranks
with DTensor parameters laid out by ``param_specs`` and the batch placed
by ``shard_batch`` (float32, no rematerialisation; the plain versions
of the kernels run per shard through ``local_map``), held against the
unsharded port and the JAX reference on the reference's weights.

Tolerances: against the unsharded port, the loss to rtol 1e-6 and each
gradient leaf to atol 1e-5 · max|g| (the sharded products sum in another
order, and the partial sums of ``data`` and ``model`` are reduced one
axis after the other); against the reference, those of
``tests/test_torch_train.py`` (loss rtol 1e-5; each leaf atol
1e-5 · max|g_ref| + rtol 1e-3).

Also: with no mesh active, or for a plain tensor, every activation helper
of ``repro_torch.parallel.act`` returns its input object itself."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_gloo import mesh_loss_worker, run_gloo
from repro.configs import get_config as jget
from repro.models import decoder as jdec
from repro_torch.configs import get_config as tget
from repro_torch.models import decoder as tdec
from repro_torch.models.convert import params_from_jax
from repro_torch.parallel import act
from repro_torch.tree import tree_leaves, tree_map, tree_map_with_path

_jvg = jax.jit(jax.value_and_grad(jdec.loss_fn), static_argnums=1,
               static_argnames=("compute_dtype", "remat"))


def _jflat(tree):
    out = {}

    def f(path, leaf):
        out["/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                     for p in path)] = np.asarray(leaf)
        return leaf

    jax.tree_util.tree_map_with_path(f, tree)
    return out


def _paths(tree):
    out = []
    tree_map_with_path(lambda p, _: out.append("/".join(map(str, p))), tree)
    return out


@pytest.mark.parametrize("arch,B,S", [("llama3.2-1b", 4, 16),
                                      ("olmoe-1b-7b", 4, 8)])
def test_sharded_loss_and_grads_match_unsharded_and_reference(arch, B, S):
    jcfg, tcfg = jget(arch, reduced=True), tget(arch, reduced=True)
    jp = jdec.init_model(jcfg, jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, tcfg.vocab, (B, S)).astype(np.int32)
    labels = rng.integers(0, tcfg.vocab, (B, S)).astype(np.int32)
    labels[0, :3] = -1                       # ignored positions too
    batch = {"tokens": tokens, "labels": labels}

    # the unsharded port
    leaves = [t.requires_grad_(True) for t in tree_leaves(tp)]
    loss = tdec.loss_fn(tp, tcfg, {k: torch.from_numpy(v)
                                   for k, v in batch.items()},
                        compute_dtype=torch.float32, remat=False)
    grads = dict(zip(_paths(tp), (g.numpy() for g in
                                  torch.autograd.grad(loss, leaves))))
    # the reference
    jl, jg = _jvg(jp, jcfg, {k: jnp.asarray(v) for k, v in batch.items()},
                  compute_dtype=jnp.float32)
    jg = _jflat(jg)

    weights = tree_map(lambda t: t.detach().numpy(), tp)
    loss = float(loss.detach())
    results = run_gloo(mesh_loss_worker, 4, arch, weights, batch)
    for m_loss, m_grads, placed, batch_pl in results:
        assert batch_pl == ["(Shard(dim=0), Replicate())"] * 2
        assert any("Shard" in p for p in placed)
        np.testing.assert_allclose(m_loss, loss, rtol=1e-6)
        np.testing.assert_allclose(m_loss, float(jl), rtol=1e-5)
        assert set(m_grads) == set(grads) == set(jg)
        for p, g in m_grads.items():
            scale = float(np.abs(grads[p]).max())
            np.testing.assert_allclose(g, grads[p], rtol=0,
                                       atol=1e-5 * scale + 1e-12,
                                       err_msg=p)
            np.testing.assert_allclose(
                g, jg[p], rtol=1e-3,
                atol=1e-5 * float(np.abs(jg[p]).max()) + 1e-12, err_msg=p)


HELPERS = {
    "shard_batch_act": act.shard_batch_act,
    "shard_logits": act.shard_logits,
    "shard_heads": lambda x: act.shard_heads(x, axis=2),
    "shard_last_dim": act.shard_last_dim,
    "shard_moe_group_buffer": act.shard_moe_group_buffer,
    "unshard": lambda x: act.unshard(x, 1),
}


class _AnyMesh:
    mesh_dim_names = ("data", "model")
    shape = (2, 2)


@pytest.mark.parametrize("name", sorted(HELPERS))
def test_helpers_return_their_input_without_a_mesh(name):
    x = torch.randn(4, 8, 2, 6)
    assert act.current_mesh() is None
    assert HELPERS[name](x) is x
    with act.use_mesh(_AnyMesh()):
        assert act.current_mesh() is not None
        assert HELPERS[name](x) is x            # a plain tensor
    assert act.current_mesh() is None


def test_gather_params_and_write_index_without_a_mesh():
    cfg = tget("llama3.2-1b", reduced=True)
    p = {"mixer": {"wq": torch.randn(8, 8)}}
    assert act.gather_params(p, cfg) is p
    buf = torch.zeros(2, 5, 3)
    act.write_index(buf, 1, 2, torch.ones(2, 3))
    act.write_index(buf, 1, 4, 7)
    want = torch.zeros(2, 5, 3)
    want[:, 2] = 1
    want[:, 4] = 7
    assert torch.equal(buf, want)
