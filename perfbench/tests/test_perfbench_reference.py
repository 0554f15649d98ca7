"""The plain reference agrees with the port's plain paths at a tiny size
in float32: serving logits (prefill, then each token decoded alone) and
the training loss, every gradient and an AdamW step."""

import numpy as np
import pytest
import torch

import _tiny
from harness import port, reference, weights

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("kind", ["moe", "dense"])
def test_served_logits_match_prefill_and_decode(kind):
    from repro_torch.models import decoder as dec

    m = {**_tiny.TINY_MODELS[kind], "dtype": "float32"}
    w = weights.make(m, 5, device=CPU, dtype=torch.float32)
    cfg = port.arch_config(m, "tiny")
    rng = np.random.default_rng(0)
    prompt = rng.integers(0, m["vocab"], 37)
    served = rng.integers(0, m["vocab"], 9)
    cache = dec.init_cache(cfg, 1, 64, dtype=torch.float32, device=CPU)
    lg, cache = dec.prefill(w, cfg, torch.tensor(prompt[None], dtype=torch.int32),
                            cache, compute_dtype=torch.float32)
    got = [lg[0, -1, :m["vocab"]]]
    for i, t in enumerate(served[:-1]):
        lg, cache = dec.decode_step(w, cfg, torch.tensor([[t]], dtype=torch.int32),
                                    cache, len(prompt) + i,
                                    compute_dtype=torch.float32)
        got.append(lg[0, 0, :m["vocab"]])
    toks = torch.tensor(np.concatenate([prompt, served[:-1]]))
    ref = reference.served_logits(w, m, toks, len(prompt))
    assert torch.allclose(torch.stack(got), ref, rtol=1e-4, atol=1e-4)


def test_training_loss_gradients_and_step_match():
    from repro_torch.models import decoder as dec
    from repro_torch.optim import adamw_init, adamw_update, clip_by_global_norm
    from repro_torch.tree import tree_leaves, tree_unflatten

    m = {**_tiny.TINY_MODELS["moe"], "dtype": "float32"}
    cfg = port.arch_config(m, "tiny")
    w = weights.make(m, 9, device=CPU, dtype=torch.float32)
    t = torch.as_tensor(np.random.default_rng(1).integers(0, m["vocab"],
                                                          (2, 65)))
    batch = {"tokens": t[:, :-1], "labels": t[:, 1:]}
    leaves = [x.detach().clone().requires_grad_(True) for x in tree_leaves(w)]
    loss = dec.loss_fn(tree_unflatten(w, leaves), cfg, batch,
                       compute_dtype=torch.float32, remat=False)
    grads = torch.autograd.grad(loss, leaves)
    ref_loss, ref_grads = reference.loss_and_grads(w, m, batch["tokens"],
                                                   batch["labels"])
    assert ref_loss == pytest.approx(float(loss.detach()), rel=1e-6)
    names = [n for n, *_ in weights.leaf_specs(m)]
    by_leaf = {id(weights.get_path(w, n)): n for n in names}
    for x, g in zip(tree_leaves(w), grads):
        r = ref_grads[by_leaf[id(x)]]
        assert torch.allclose(g, r, rtol=1e-4, atol=1e-6 * float(r.abs().max())), \
            by_leaf[id(x)]
    # one clipped AdamW step on each side from the same gradients
    ordered = [ref_grads[by_leaf[id(x)]].clone() for x in tree_leaves(w)]
    g_tree, _ = clip_by_global_norm(tree_unflatten(w, ordered), 1.0)
    w_port = tree_unflatten(w, [x.clone() for x in tree_leaves(w)])
    adamw_update(w_port, g_tree, adamw_init(w_port), lr=3e-4,
                 weight_decay=0.1)
    w_ref = tree_unflatten(w, [x.clone() for x in tree_leaves(w)])
    state = {"count": 0,
             "mu": {n: torch.zeros_like(weights.get_path(w, n)) for n in names},
             "nu": {n: torch.zeros_like(weights.get_path(w, n)) for n in names}}
    reference.adamw_ref(w_ref, {n: ref_grads[n] for n in names}, state,
                        lr=3e-4, weight_decay=0.1, clip=1.0)
    for a, b in zip(tree_leaves(w_port), tree_leaves(w_ref)):
        assert torch.allclose(a, b, rtol=1e-6, atol=1e-7)
