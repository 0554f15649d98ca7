"""Step functions: train / prefill / one-token serve (port of
``repro.launch.steps``)."""

from __future__ import annotations

import torch

from repro_torch.models import decoder as dec
from repro_torch.models.config import ArchConfig
from repro_torch.obs.trace import span
from repro_torch.optim import adamw_init, adamw_update, clip_by_global_norm
from repro_torch.tree import tree_leaves, tree_unflatten

#: default microbatch size (global examples per grad-accumulation step);
#: bounds live activation memory to O(layers × microbatch × seq × d_model)
DEFAULT_MICROBATCH = 32


def make_train_step(cfg: ArchConfig, *, lr: float = 3e-4,
                    weight_decay: float = 0.1, clip: float = 1.0,
                    compute_dtype=torch.bfloat16, remat: bool = True,
                    microbatch: int | None = DEFAULT_MICROBATCH):
    """Train step with gradient-accumulation microbatching: the batch is
    split into microbatches run one after another, their gradients summed
    and averaged, so per-layer checkpointed activations exist for one
    microbatch at a time.  The split rule is the reference's:
    ``n_micro = max(1, B // m)`` when ``m`` divides B, else one batch.

    ``train_step(params, opt_state, batch)`` takes a tree of tensors, an
    :class:`~repro_torch.optim.OptState` and {"tokens", "labels"} (B, S)
    integer tensors (plus the (B, N, D) "context" of the audio and
    vision archs) on the parameters' device, and returns
    ``(params, opt_state, {"loss", "grad_norm"})`` with the metrics as
    device scalars.  The update is in place (see
    :mod:`repro_torch.optim.optimizers`).

    While :mod:`repro_torch.obs` or a ``torch.profiler`` session records,
    the step records spans, timed on the device: ``train.step`` (args
    ``n_micro``, ``batch``, ``seq``) holding ``train.forward`` and
    ``train.backward`` per microbatch, then ``train.clip`` and
    ``train.optimizer``."""

    def grads_of(params, mb):
        leaves = [t.detach().requires_grad_(True)
                  for t in tree_leaves(params)]
        with torch.enable_grad():
            with span("train.forward", "train"):
                loss = dec.loss_fn(tree_unflatten(params, leaves), cfg, mb,
                                   compute_dtype=compute_dtype, remat=remat)
            # on CUDA the autograd engine runs the backward, and the
            # checkpointed recompute with it, on a thread of its own: the
            # spans it opens there have no parent (repro_torch.obs.trace)
            with span("train.backward", "train"):
                grads = torch.autograd.grad(loss, leaves)
        return loss.detach(), list(grads)

    def train_step(params, opt_state, batch):
        B, S = batch["tokens"].shape
        m = microbatch or B
        n_micro = max(1, B // m) if B % (m or 1) == 0 else 1
        with span("train.step", "train", n_micro=n_micro, batch=B, seq=S):
            if n_micro > 1:
                size = B // n_micro
                grads, loss = None, None
                for i in range(n_micro):
                    mb = {k: v[i * size:(i + 1) * size]
                          for k, v in batch.items()}
                    l_i, g_i = grads_of(params, mb)
                    if grads is None:
                        grads, loss = g_i, l_i
                    else:
                        for acc, g in zip(grads, g_i):
                            acc.add_(g)
                        loss = loss + l_i
                for g in grads:
                    g.div_(n_micro)
                loss = loss / n_micro
            else:
                loss, grads = grads_of(params, batch)
            with span("train.clip", "train"):
                grads, gnorm = clip_by_global_norm(
                    tree_unflatten(params, grads), clip)
            with span("train.optimizer", "train"):
                params, opt_state = adamw_update(
                    params, grads, opt_state, lr=lr,
                    weight_decay=weight_decay)
        return params, opt_state, {"loss": loss, "grad_norm": gnorm}

    return train_step


def make_prefill_step(cfg: ArchConfig, *, compute_dtype=torch.bfloat16):
    @torch.no_grad()
    def prefill_step(params, batch):
        logits, _ = dec.forward(params, cfg, batch["tokens"],
                                context=batch.get("context"),
                                compute_dtype=compute_dtype, remat=False)
        return logits

    return prefill_step


def make_serve_step(cfg: ArchConfig, *, compute_dtype=torch.bfloat16):
    @torch.no_grad()
    def serve_step(params, token, cache, index):
        return dec.decode_step(params, cfg, token, cache, index,
                               compute_dtype=compute_dtype)

    return serve_step


def init_train_state(cfg: ArchConfig, *, seed: int = 0, device=None,
                     dtype=torch.float32):
    """Parameters from ``seed`` (:func:`~repro_torch.models.decoder.init_model`)
    and zero AdamW moments, on ``device`` (default ``cuda``)."""
    params = dec.init_model(cfg, seed=seed, device=device, dtype=dtype)
    return params, adamw_init(params)
