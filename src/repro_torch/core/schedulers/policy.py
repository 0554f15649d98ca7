"""Policy networks for RL scheduling (HeterPS §5.2, Fig. 3; the port of
``repro.core.schedulers.policy``).

The LSTM reads one layer per step.  Step ``l``'s input is the layer's five
features (Fig. 3: one-hot index, one-hot layer type, input size, weight
size, communication time) concatenated with the one-hot of the previous
action — the autoregressive conditioning ``P(a_l | a_{(l-1):1}; θ)`` of
Formula 14.  The per-step output is a ``T``-way softmax over resource
types.  An Elman RNN cell with the same interface is the paper's RL-RNN
baseline (§6.2).

:class:`Policy` holds the parameters of ``M`` independent policies on a
leading model axis (``RLScheduler.schedule_many`` searches several models
at once), under the reference's names: ``wx``, ``wh``, ``b``, ``wo``,
``bo``, ``h0`` and, for the LSTM, ``c0``.  The cell is written out (gate
order i, f, g, o; ``+1.0`` on the forget gate) with the input projection
hoisted out of the recurrence, as in the reference.  :func:`sample`,
:func:`greedy` and :func:`plan_logp` unroll it over the layers.
"""

from __future__ import annotations

import math
from typing import Callable, Mapping, Sequence

import numpy as np
import torch
from torch import nn

from repro_torch.core.profiles import LAYER_KINDS, LayerProfile

MAX_LAYERS = 64  # one-hot index capacity (paper models have <= 20 layers)

#: parameter names in the reference's order (``c0`` only for the LSTM)
PARAM_NAMES = ("wx", "wh", "b", "wo", "bo", "h0", "c0")


def layer_features(
    profiles: Sequence[LayerProfile],
    *,
    pad_to: int | None = None,
    return_mask: bool = False,
) -> np.ndarray | tuple[np.ndarray, np.ndarray]:
    """(L, F) float32 feature matrix — the five Fig.-3 features per layer.

    ``pad_to`` appends all-zero rows up to a common layer count so several
    models can share one search; ``return_mask`` also returns the
    (pad_to,) bool validity mask that zeroes padded steps out of the
    log-probs.  Models deeper than :data:`MAX_LAYERS` are rejected: the
    index one-hot would alias every layer past slot ``MAX_LAYERS - 1``
    onto one column.
    """
    L = len(profiles)
    if L > MAX_LAYERS:
        raise ValueError(
            f"{L} layers exceed the policy's index one-hot capacity "
            f"MAX_LAYERS={MAX_LAYERS}; layers {MAX_LAYERS}..{L - 1} would "
            f"alias onto one slot — raise policy.MAX_LAYERS"
        )
    P = pad_to if pad_to is not None else L
    if P < L:
        raise ValueError(f"pad_to={P} < {L} layers")
    kind_ix = {k: i for i, k in enumerate(LAYER_KINDS)}
    feats = np.zeros((P, MAX_LAYERS + len(LAYER_KINDS) + 3), dtype=np.float32)
    for i, p in enumerate(profiles):
        feats[i, i] = 1.0                                            # index
        feats[i, MAX_LAYERS + kind_ix.get(p.kind, 0)] = 1.0          # type
        base = MAX_LAYERS + len(LAYER_KINDS)
        feats[i, base + 0] = math.log1p(p.input_bytes) / 20.0        # input size
        feats[i, base + 1] = math.log1p(p.weight_bytes) / 20.0       # weight size
        feats[i, base + 2] = math.log1p(1e6 * float(np.mean(p.odt))) / 20.0  # comm
    if return_mask:
        return feats, np.arange(P) < L
    return feats


class Policy(nn.Module):
    """``M`` LSTM (``cell="lstm"``) or Elman RNN (``cell="rnn"``) policies,
    float32, each parameter with a leading model axis: ``wx`` (M, F + T,
    G·H), ``wh`` (M, H, G·H), ``b`` (M, G·H), ``wo`` (M, H, T), ``bo``
    (M, T), ``h0`` and ``c0`` (M, H), with ``G`` = 4 gates for the LSTM
    and 1 for the RNN."""

    def __init__(self, cell: str, tensors: Mapping[str, torch.Tensor]):
        super().__init__()
        if cell not in ("lstm", "rnn"):
            raise ValueError(f"cell must be 'lstm' or 'rnn', got {cell!r}")
        self.cell = cell
        for name in self.names():
            self.register_parameter(name, nn.Parameter(
                tensors[name].to(torch.float32).clone()))

    @classmethod
    def names_for(cls, cell: str) -> tuple[str, ...]:
        return PARAM_NAMES if cell == "lstm" else PARAM_NAMES[:-1]

    def names(self) -> tuple[str, ...]:
        return self.names_for(self.cell)

    def params(self) -> list[nn.Parameter]:
        """The parameters in :data:`PARAM_NAMES` order."""
        return [getattr(self, n) for n in self.names()]

    @property
    def hidden(self) -> int:
        return self.wh.shape[1]


def init_policy(cell: str, in_dim: int, hidden: int, num_types: int, *,
                models: int = 1, generator: torch.Generator | None = None,
                device=None) -> Policy:
    """A fresh policy: ``wx``, ``wh``, ``wo`` uniform in ±1/√hidden (drawn
    on the CPU from ``generator``, so a seed gives the same weights on
    every device), biases and initial state zero; the same weights for
    each of the ``models``."""
    gates = 4 if cell == "lstm" else 1
    s = 1.0 / math.sqrt(hidden)

    def u(*shape):
        x = torch.rand(shape, generator=generator, dtype=torch.float32)
        return (x * (2 * s) - s)[None].expand(models, *shape)

    z = lambda *shape: torch.zeros((models, *shape))  # noqa: E731
    tensors = {"wx": u(in_dim, gates * hidden), "wh": u(hidden, gates * hidden),
               "b": z(gates * hidden), "wo": u(hidden, num_types),
               "bo": z(num_types), "h0": z(hidden), "c0": z(hidden)}
    return Policy(cell, tensors).to(device)


def params_from_reference(params_np: Mapping[str, np.ndarray], *,
                          models: int = 1, device=None) -> Policy:
    """The reference's ``init_lstm``/``init_rnn`` parameter dict (as NumPy
    arrays) as a :class:`Policy`: the cell is the LSTM when ``c0`` is
    present; arrays without a model axis are repeated ``models`` times."""
    cell = "lstm" if "c0" in params_np else "rnn"
    one_model = np.asarray(params_np["wh"]).ndim == 2
    tensors = {}
    for n in Policy.names_for(cell):
        t = torch.from_numpy(np.array(params_np[n], dtype=np.float32))
        tensors[n] = t[None].expand(models, *t.shape) if one_model else t
    return Policy(cell, tensors).to(device)


def _unroll(policy: Policy, feats: torch.Tensor, plans: int,
            choose: Callable[[int, torch.Tensor], torch.Tensor],
            mask: torch.Tensor | None) -> tuple[torch.Tensor, torch.Tensor]:
    """Run the recurrence over the layers for ``plans`` plans per model.

    ``feats`` is (M, L, F); ``choose(l, logits)`` picks step ``l``'s
    actions (M, plans) from its logits (M, plans, T).  Returns the actions
    (M, plans, L) and the plans' summed log-probs (M, plans) under the
    policy, with masked steps weighted out.

    Step ``l``'s input is ``concat(feats[l], one_hot(prev_a))``; its
    pre-activation share is ``feats[l] @ wx_f + wx_a[prev_a]``, where
    ``wx_f``/``wx_a`` split ``wx``'s rows: the feature half is one (L,
    G·H) product for all steps and plans, the action half a row gather.
    """
    M, L, F = feats.shape
    xf = feats @ policy.wx[:, :F]                    # (M, L, G·H)
    wx_a = policy.wx[:, F:]                          # (M, T, G·H)
    H = policy.hidden
    h = policy.h0[:, None, :].expand(M, plans, H)
    c = policy.c0[:, None, :].expand(M, plans, H) if policy.cell == "lstm" \
        else None
    m = (torch.ones((M, L), dtype=feats.dtype, device=feats.device)
         if mask is None else mask.to(feats.dtype))
    rows = torch.arange(M, device=feats.device)[:, None]
    prev = torch.zeros((M, plans), dtype=torch.int64, device=feats.device)
    actions, logps = [], []
    for l in range(L):
        zx = xf[:, l, None, :] + wx_a[rows, prev]
        z = zx + h @ policy.wh + policy.b[:, None, :]
        if c is not None:
            i, f, g, o = z.chunk(4, dim=-1)
            i, f, o = torch.sigmoid(i), torch.sigmoid(f + 1.0), torch.sigmoid(o)
            c = f * c + i * torch.tanh(g)
            h = o * torch.tanh(c)
        else:
            h = torch.tanh(z)
        logits = h @ policy.wo + policy.bo[:, None, :]
        a = choose(l, logits)
        lp = torch.log_softmax(logits, -1).gather(-1, a[..., None])[..., 0]
        actions.append(a)
        logps.append(lp * m[:, l, None])
        prev = a
    return torch.stack(actions, -1), torch.stack(logps, -1).sum(-1)


def _model_axis(feats: torch.Tensor) -> torch.Tensor:
    return feats[None] if feats.dim() == 2 else feats


def gumbel_noise(generator: torch.Generator, shape) -> torch.Tensor:
    """Standard Gumbel noise, float32 on the CPU: ``-log(-log(U))`` with
    ``U`` uniform in [tiny, 1) from ``generator``."""
    u = torch.rand(shape, generator=generator, dtype=torch.float32)
    return -torch.log(-torch.log(
        torch.clamp_min(u, torch.finfo(torch.float32).tiny)))


def sample(policy: Policy, feats: torch.Tensor, g: torch.Tensor, *,
           temperature: float = 1.0,
           mask: torch.Tensor | None = None
           ) -> tuple[torch.Tensor, torch.Tensor]:
    """Sample plans autoregressively with the Gumbel noise ``g``.

    ``g`` is (M, N, L, T), or broadcasts to it (an (N, L, T) draw shared
    by every model); step ``l`` takes ``argmax(logits / temperature +
    g[..., l, :])``, a draw from the tempered softmax.  Returns actions
    (M, N, L) int64 and each plan's log-probability (M, N) under the
    *untempered* policy — the quantity Formula 15 differentiates, so the
    REINFORCE gradient can be taken by autograd through this pass.
    ``mask`` (M, L) marks real layer rows: padded rows still sample an
    action but add no log-prob.
    """
    feats = _model_axis(feats)

    def choose(l, logits):
        return torch.argmax(logits / temperature + g[..., l, :], dim=-1)

    return _unroll(policy, feats, g.shape[-3], choose, mask)


@torch.no_grad()
def greedy(policy: Policy, feats: torch.Tensor) -> torch.Tensor:
    """Argmax decode (M, L) — the final scheduling decision (§5.2).
    Callers with padded feature rows truncate to the real layer count."""
    feats = _model_axis(feats)
    actions, _ = _unroll(policy, feats, 1,
                         lambda l, logits: torch.argmax(logits, dim=-1), None)
    return actions[:, 0]


def plan_logp(policy: Policy, feats: torch.Tensor, actions: torch.Tensor, *,
              mask: torch.Tensor | None = None) -> torch.Tensor:
    """Teacher-forced Σ_l log P(a_l | a_{(l-1):1}; θ) (Formula 14) of
    ``actions`` (M, N, L): (M, N)."""
    feats = _model_axis(feats)
    actions = actions.to(torch.int64)
    _, logp = _unroll(policy, feats, actions.shape[1],
                      lambda l, logits: actions[..., l], mask)
    return logp


def reinforce_grad(policy: Policy, feats: torch.Tensor, actions: torch.Tensor,
                   advantages: torch.Tensor, *,
                   mask: torch.Tensor | None = None) -> list[torch.Tensor]:
    """∇θ of the REINFORCE surrogate (Formula 15): per model, the mean
    over its plans of ``advantage · log P(plan)`` — the gradient *ascent*
    direction on reward.  ``advantages`` is (M, N); the gradients come in
    :meth:`Policy.params` order."""
    logp = plan_logp(policy, feats, actions, mask=mask)
    return list(torch.autograd.grad((advantages * logp).mean(-1).sum(),
                                    policy.params()))
