"""The plain reference of the CTR cells, and the inputs both sides get.

Written from the configuration's ``ctr`` block, in plain ``torch`` with
TF32 off, importing nothing of the program.  One step: gather each
example's ``slots`` rows from a dense table, concatenate them, run the
tower (``h @ w + b``, tanh between layers, one logit), take the mean
binary cross-entropy on the logits, step the tower by SGD
(``p - lr · g``) and every distinct row by ``rows -= lr · emb_lr_scale ·
Σ grads``, the sum over the row's appearances in the batch.  The same
step on rows the program pulled (:func:`step`) judges a step of the
asynchronous window, and :func:`push_sum` what the window's pushes add
to the table.

:func:`init_table` and :func:`init_tower` make the initial weights on the
device from the seed, each from a ``torch.Generator`` of its own, so the
benchmark hands the same tensors to the program and makes them again for
the reference after the window.
"""

from __future__ import annotations

import contextlib

import torch

_SEED_MASK = (1 << 62) - 1


def _generator(seed: int, stream: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(
        (seed * 4 + stream) & _SEED_MASK)


def tower_dims(c: dict) -> list[int]:
    return [c["slots"] * c["emb_dim"], *c["tower"], 1]


def init_table(c: dict, seed: int, device) -> torch.Tensor:
    """The ``(vocab, emb_dim)`` float32 table, ``N(0, 1) · init_scale``."""
    g = _generator(seed, 0, device)
    t = torch.randn((c["vocab"], c["emb_dim"]), generator=g, device=device,
                    dtype=torch.float32)
    return t.mul_(c["init_scale"])


def init_tower(c: dict, seed: int, device) -> dict:
    """``{"w": [(in, out), …], "b": [(out,), …]}``: weights
    ``N(0, 1/in)``, biases zero, float32."""
    g = _generator(seed, 1, device)
    dims = tower_dims(c)
    return {"w": [torch.randn((a, b), generator=g, device=device) * a**-0.5
                  for a, b in zip(dims[:-1], dims[1:])],
            "b": [torch.zeros((b,), device=device) for b in dims[1:]]}


def leaf_names(c: dict) -> list[str]:
    n = len(tower_dims(c)) - 1
    return [f"w{i}" for i in range(n)] + [f"b{i}" for i in range(n)]


def leaves(tower: dict) -> list[torch.Tensor]:
    return [*tower["w"], *tower["b"]]


@contextlib.contextmanager
def no_tf32():
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def _mm(h, w, quant):
    if quant == "bf16":
        return (h.bfloat16() @ w.bfloat16()).float()
    if quant is not None:
        raise ValueError(f"unknown precision {quant!r}")
    return h @ w


def logits(ws, bs, emb, quant=None):
    h = emb.reshape(emb.shape[0], -1)
    for i, (w, b) in enumerate(zip(ws, bs)):
        h = _mm(h, w, quant) + b
        if i < len(ws) - 1:
            h = torch.tanh(h)
    return h[:, 0]


def bce(logit, y):
    """Mean binary cross-entropy on the logits, in its stable form."""
    return torch.mean(torch.clamp(logit, min=0) - logit * y
                      + torch.log1p(torch.exp(-logit.abs())))


def step(c: dict, tower: dict, emb: torch.Tensor, labels,
         *, quant=None) -> tuple[float, dict, torch.Tensor]:
    """One step of the tower on gathered rows ``emb`` ``(batch, slots,
    emb_dim)``: ``(loss, the tower after SGD, the rows' gradients)``.
    ``quant="bf16"`` computes the tower's products in bfloat16 (the
    control)."""
    y = torch.as_tensor(labels, device=emb.device)
    ws = [w.detach().clone().requires_grad_() for w in tower["w"]]
    bs = [x.detach().clone().requires_grad_() for x in tower["b"]]
    emb = emb.detach().clone().requires_grad_()
    with no_tf32(), torch.enable_grad():
        loss = bce(logits(ws, bs, emb, quant), y)
        grads = torch.autograd.grad(loss, ws + bs + [emb])
    n = len(ws)
    with torch.no_grad():
        tower = {"w": [w - c["lr"] * g for w, g in zip(ws, grads)],
                 "b": [x - c["lr"] * g for x, g in zip(bs, grads[n:2 * n])]}
    return float(loss.detach()), tower, grads[-1]


def steps(c: dict, table: torch.Tensor, tower: dict, batches,
          *, quant=None) -> dict:
    """Train ``tower`` and ``table`` (updated in place) over ``batches``
    (``{"ids", "label"}`` host arrays), a :func:`step` each on the rows
    its ids gather.  Returns each step's ``losses`` and the tower after
    each step (``towers``, the first the initial one)."""
    dev = table.device
    emb_lr = c["lr"] * c["emb_lr_scale"]
    losses, towers = [], [tower]
    for b in batches:
        ids = torch.as_tensor(b["ids"], device=dev).long()
        loss, tower, g = step(c, tower, table[ids], b["label"], quant=quant)
        with torch.no_grad():
            uniq, inv = torch.unique(ids.reshape(-1), return_inverse=True)
            summed = torch.zeros((uniq.numel(), c["emb_dim"]), device=dev,
                                 dtype=g.dtype).index_add_(
                0, inv, g.reshape(-1, c["emb_dim"]))
            table[uniq] -= emb_lr * summed
        losses.append(loss)
        towers.append(tower)
    return {"losses": losses, "towers": towers}


def push_sum(c: dict, ids, grads, device) -> tuple[torch.Tensor, torch.Tensor]:
    """What a run of pushes adds to the table, whatever order they landed
    in: the distinct ids of the steps' ``ids`` (each ``(batch, slots)``)
    and, per id, ``-lr · emb_lr_scale · Σ`` of the row gradients ``grads``
    pushed at it (float64 on ``device``)."""
    d = c["emb_dim"]
    flat = [torch.as_tensor(i, device=device).reshape(-1).long() for i in ids]
    if not flat:
        return (torch.zeros((0,), dtype=torch.long, device=device),
                torch.zeros((0, d), dtype=torch.float64, device=device))
    uniq, inv = torch.unique(torch.cat(flat), return_inverse=True)
    total = torch.zeros((uniq.numel(), d), dtype=torch.float64,
                        device=device)
    start = 0
    for i, g in zip(flat, grads):
        total.index_add_(0, inv[start:start + i.numel()],
                         g.reshape(-1, d).to(device, torch.float64))
        start += i.numel()
    return uniq, total.mul_(-c["lr"] * c["emb_lr_scale"])
