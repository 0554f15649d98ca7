"""The plain reference: the configured decoder in float32, written from the
configuration's description with plain ``torch`` operations (TF32 off).
It imports nothing of the program and takes from the benchmark only the
weights it made and the tokens it sent.

What the configuration states, and this computes:

* token embedding; per layer: RMSNorm (eps from the config, computed in
  float32), attention with ``n_heads`` query heads over ``n_kv_heads``
  key/value heads (query head h reads key/value head h // (H / KV)),
  optional RMSNorm of each q and k head, rotary embedding of interleaved
  pairs over the first ``rope_fraction`` of each head, causal softmax
  scaled by 1/sqrt(head_dim); residual; RMSNorm; a SwiGLU feed-forward
  (dense) or a mixture of experts; residual; final RMSNorm; the head;
* the mixture of experts: router softmax in float32, the top-k experts
  (ties to the lower index), gates renormalised to sum to 1, each
  expert a SwiGLU; within a routing group every (token, choice) pair in
  token-major order takes the next free row of its expert, and pairs past
  the expert's capacity ``max(8, ceil8(ceil(n·k·cf / E)))`` are dropped
  (their gate weight is lost; the residual carries the token on);
* the training loss: mean token cross-entropy over every column of the
  (padded) head plus ``moe_aux_coef`` times the mean over layers of the
  Switch load-balance term ``E · Σ_e density_e · mean_prob_e`` with
  density from each token's first choice.

``quant="fp8"`` computes the same with both operands of every
projection (the embedding, attention's q/k/v/o, the router, the experts
or the feed-forward, the head) rounded to float8 e4m3: the weights with a
scale per output channel, the activations with a scale per row, as an
fp8 matrix product takes them; attention's own products and the norms
stay in float32.  It is the control that stands for the next precision
below bfloat16.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F


@contextlib.contextmanager
def exact_f32():
    """float32 products without TF32."""
    m, c = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c


def qdq_fp8(w: torch.Tensor, in_dim: int) -> torch.Tensor:
    """``w`` rounded to float8 e4m3 with one scale per slice along
    ``in_dim`` (the reduction axis), back in float32; the gradient passes
    straight through."""
    w = w.float()
    amax = w.detach().abs().amax(dim=in_dim, keepdim=True).clamp_min(1e-12)
    scale = amax / 448.0
    q = (w / scale).to(torch.float8_e4m3fn).float() * scale
    return w + (q - w).detach()


def mm(x, w, quant):
    """x @ w, with x's rows rounded to float8 first under ``quant``
    (``w`` comes rounded from :func:`_w`)."""
    if quant == "fp8":
        x = qdq_fp8(x, -1)
    return x @ w


def _w(t: torch.Tensor, quant: str | None, in_dim: int = -2):
    if quant == "fp8":
        return qdq_fp8(t, in_dim)
    if quant is not None:
        raise ValueError(f"unknown quant {quant!r}")
    return t.float()


def rms(x, w, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w.float()


def rope(x, positions, theta: float, fraction: float):
    """x (..., S, heads, hd); interleaved pairs of the first
    ``fraction`` of hd."""
    hd = x.shape[-1]
    rot = int(hd * fraction) // 2 * 2
    if rot == 0:
        return x
    i = torch.arange(0, rot, 2, dtype=torch.float64, device=x.device)
    inv = theta ** (-i / rot)
    ang = positions.to(torch.float64)[..., None] * inv       # (..., S, rot/2)
    cos = torch.cos(ang).float()[..., None, :]
    sin = torch.sin(ang).float()[..., None, :]
    a, b = x[..., :rot:2], x[..., 1:rot:2]
    ra = a * cos - b * sin
    rb = b * cos + a * sin
    out = torch.stack([ra, rb], dim=-1).flatten(-2)
    return torch.cat([out, x[..., rot:]], dim=-1)


def capacity(n_tokens: int, m: dict) -> int:
    cap = math.ceil(n_tokens * m["top_k"] * m["capacity_factor"]
                    / m["n_experts"])
    return max(8, -(-cap // 8) * 8)


def _layer_weights(w, r: int, m: dict, quant):
    b = w["blocks"][0]
    p = {"norm1": b["norm1"][r].float(), "norm2": b["norm2"][r].float()}
    for k in ("wq", "wk", "wv", "wo"):
        p[k] = _w(b["mixer"][k][r], quant)
    if m.get("qk_norm"):
        p["q_norm"] = b["mixer"]["q_norm"][r].float()
        p["k_norm"] = b["mixer"]["k_norm"][r].float()
    for k in b["ffn"]:
        p[k] = _w(b["ffn"][k][r], quant)
    p["quant"] = quant
    return p


def attention(p, h, positions, m: dict, *, q_chunk: int = 1024):
    """Causal self-attention of one sequence h (S, d) → (S, d)."""
    S = h.shape[0]
    H, KV, hd = m["n_heads"], m["n_kv_heads"], m["head_dim"]
    G = H // KV
    qt = p.get("quant")
    q = mm(h, p["wq"], qt).reshape(S, H, hd)
    k = mm(h, p["wk"], qt).reshape(S, KV, hd)
    v = mm(h, p["wv"], qt).reshape(S, KV, hd)
    if m.get("qk_norm"):
        q = rms(q, p["q_norm"], m["norm_eps"])
        k = rms(k, p["k_norm"], m["norm_eps"])
    q = rope(q, positions, m["rope_theta"], m["rope_fraction"])
    k = rope(k, positions, m["rope_theta"], m["rope_fraction"])
    q = q.reshape(S, KV, G, hd)
    out = []
    scale = 1.0 / math.sqrt(hd)
    for s0 in range(0, S, q_chunk):
        s1 = min(S, s0 + q_chunk)
        sc = torch.einsum("qkgd,skd->kgqs", q[s0:s1], k[:s1]) * scale
        qi = torch.arange(s0, s1, device=h.device)[:, None]
        ki = torch.arange(s1, device=h.device)[None, :]
        sc = sc.masked_fill(ki > qi, float("-inf"))
        a = torch.softmax(sc, dim=-1)
        out.append(torch.einsum("kgqs,skd->qkgd", a, v[:s1]))
    o = torch.cat(out, 0).reshape(S, H * hd)
    return mm(o, p["wo"], qt)


def swiglu(x, w1, w3, w2, quant=None):
    return mm(F.silu(mm(x, w1, quant)) * mm(x, w3, quant), w2, quant)


def moe(p, h, m: dict, groups: list[tuple[int, int]]):
    """Mixture of experts over tokens h (N, d).  ``groups``: the (start,
    end) token ranges routed as one capacity group each; tokens outside
    every range are groups of one (capacity 8: never full).  Returns
    (y (N, d), probs (N, E) float32, first choice (N,))."""
    N = h.shape[0]
    E, K = m["n_experts"], m["top_k"]
    qt = p.get("quant")
    probs = torch.softmax(mm(h, p["router"], qt), dim=-1)
    vals, eid = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, eid = vals[:, :K], eid[:, :K]
    gate = gate / gate.sum(-1, keepdim=True)
    keep = torch.ones(N, K, dtype=torch.bool, device=h.device)
    for s0, s1 in groups:
        flat = eid[s0:s1].reshape(-1)
        rank = F.one_hot(flat, E).cumsum(0) - 1
        pos = rank.gather(1, flat[:, None])[:, 0]
        keep[s0:s1] = (pos < capacity(s1 - s0, m)).reshape(s1 - s0, K)
    y = torch.zeros_like(h)
    for e in range(E):
        tok, kk = torch.nonzero((eid == e) & keep, as_tuple=True)
        if tok.numel() == 0:
            continue
        ye = swiglu(h[tok], p["w1"][e], p["w3"][e], p["w2"][e], qt)
        y.index_add_(0, tok, ye * gate[tok, kk, None])
    return y, probs, eid[:, 0]


def ffn(p, h, m: dict, groups):
    if m["ffn"] == "moe":
        return moe(p, h, m, groups)
    return swiglu(h, p["w1"], p["w3"], p["w2"], p.get("quant")), None, None


def layer(p, x, positions, m: dict, groups):
    """One decoder layer of one sequence x (S, d) float32 → (x, probs,
    first choice)."""
    eps = m["norm_eps"]
    x = x + attention(p, rms(x, p["norm1"], eps), positions, m)
    y, probs, first = ffn(p, rms(x, p["norm2"], eps), m, groups)
    return x + y, probs, first


def embed(w, tokens, quant):
    e = w["embed"]
    rows = e[tokens]
    return _w(rows, quant, in_dim=-1)


@torch.no_grad()
def served_logits(w, m: dict, tokens: torch.Tensor, n_prompt: int,
                  quant: str | None = None) -> torch.Tensor:
    """Logits (S - n_prompt + 1, vocab) in float32 at the positions that
    predict the served tokens: ``tokens`` is the prompt followed by the
    served tokens but the last.  The prompt routes as one group, each
    later token alone (as served)."""
    with exact_f32():
        S = tokens.shape[0]
        pos = torch.arange(S, device=tokens.device)
        x = embed(w, tokens, quant)
        for r in range(m["n_layers"]):
            p = _layer_weights(w, r, m, quant)
            x, _, _ = layer(p, x, pos, m, [(0, n_prompt)])
            del p
        x = rms(x[n_prompt - 1:], w["final_norm"].float(), m["norm_eps"])
        head = _w(w["lm_head"][:, :m["vocab"]], quant)
        return mm(x, head, quant)


# --------------------------------------------------------------------------
# training: loss, gradients and AdamW, layer by layer
# --------------------------------------------------------------------------

_LAYER_LEAVES = ("norm1", "mixer.wq", "mixer.wk", "mixer.wv", "mixer.wo",
                 "mixer.q_norm", "mixer.k_norm", "norm2", "ffn.router",
                 "ffn.w1", "ffn.w3", "ffn.w2")


def layer_leaves(w) -> list[str]:
    """The per-layer leaf names (``mixer.wq`` …) that the tree holds."""
    b = w["blocks"][0]
    out = []
    for name in _LAYER_LEAVES:
        node = b
        for k in name.split("."):
            node = node.get(k) if isinstance(node, dict) else None
            if node is None:
                break
        if node is not None:
            out.append(name)
    return out


def _leaf(w, name: str):
    node = w["blocks"][0]
    for k in name.split("."):
        node = node[k]
    return node


def _train_layer_params(w, r: int, names, quant, *, grad: bool):
    p = {}
    for n in names:
        t = _leaf(w, n)[r]
        is_norm = n.endswith("norm1") or n.endswith("norm2") or n.endswith(
            "_norm")
        t = t.float() if is_norm else _w(t, quant)
        p[n.split(".")[-1]] = t.detach().requires_grad_(grad)
    p["quant"] = quant
    return p


def train_layer(p, x, m: dict):
    """One layer over a batch x (B, S, d): (x, Switch load-balance term
    or 0)."""
    B, S, d = x.shape
    eps = m["norm_eps"]
    pos = torch.arange(S, device=x.device)
    h = rms(x, p["norm1"], eps)
    x = x + torch.stack([attention(p, h[b], pos, m) for b in range(B)])
    h = rms(x, p["norm2"], eps).reshape(B * S, d)
    groups = [(b * S, (b + 1) * S) for b in range(B)]
    y, probs, first = ffn(p, h, m, groups)
    aux = x.new_zeros(())
    if probs is not None:
        E = m["n_experts"]
        density = F.one_hot(first, E).float().mean(0)
        aux = E * torch.sum(density * probs.mean(0))
    return x + y.reshape(B, S, d), aux


def loss_and_grads(w, m: dict, tokens, labels, *, quant=None,
                   row_chunk: int = 2048):
    """Mean token cross-entropy (over every column of the padded head)
    plus the MoE load-balance term, and the gradient of every leaf, in
    float32 a layer at a time (activations kept only at layer inputs,
    each layer recomputed in the backward pass).  Gradients are stored in
    the leaves' own type.  Returns (loss, {name: grad})."""
    with exact_f32():
        B, S = tokens.shape
        L = m["n_layers"]
        names = layer_leaves(w)
        coef = m.get("moe_aux_coef", 0.0) / L
        with torch.no_grad():
            xs = [embed(w, tokens, quant)]
            aux_sum = 0.0
            for r in range(L):
                p = _train_layer_params(w, r, names, quant, grad=False)
                x, aux = train_layer(p, xs[-1], m)
                xs.append(x)
                aux_sum += float(aux)
        grads = {"blocks.0." + n: torch.empty_like(_leaf(w, n))
                 for n in names}
        # head and final norm, over row chunks
        fnorm = w["final_norm"].float().requires_grad_(True)
        head = _w(w["lm_head"], quant).requires_grad_(True)
        xl = xs[-1].reshape(B * S, -1)
        lab = labels.reshape(-1)
        n = lab.numel()
        nll = 0.0
        dx = torch.zeros_like(xl)
        g_norm = torch.zeros_like(fnorm)
        g_head = torch.zeros_like(head)
        for s0 in range(0, n, row_chunk):
            xc = xl[s0:s0 + row_chunk].detach().requires_grad_(True)
            lg = mm(rms(xc, fnorm, m["norm_eps"]), head, quant)
            part = (torch.logsumexp(lg, -1)
                    - lg.gather(1, lab[s0:s0 + row_chunk, None])[:, 0]).sum()
            a, b, c = torch.autograd.grad(part / n, [xc, fnorm, head])
            dx[s0:s0 + row_chunk] = a
            g_norm += b
            g_head += c
            nll += float(part.detach())
            del lg, part
        grads["final_norm"] = g_norm.to(w["final_norm"].dtype)
        grads["lm_head"] = g_head.to(w["lm_head"].dtype)
        del g_head, head
        dy = dx.reshape(B, S, -1)
        for r in reversed(range(L)):
            p = _train_layer_params(w, r, names, quant, grad=True)
            xr = xs[r].detach().requires_grad_(True)
            with torch.enable_grad():
                y, aux = train_layer(p, xr, m)
                outs, gouts = [y], [dy]
                if aux.requires_grad:
                    outs.append(aux)
                    gouts.append(torch.tensor(coef, device=y.device))
                keys = [k for k in p if k != "quant"]
                got = torch.autograd.grad(outs, [xr] + [p[k] for k in keys],
                                          gouts, allow_unused=True)
            dy = got[0]
            for n_, k, g in zip(names, keys, got[1:]):
                dst = grads["blocks.0." + n_][r]
                if g is None:
                    dst.zero_()
                else:
                    dst.copy_(g)
            xs[r + 1] = None
            del p, y, got
        g_embed = torch.zeros(w["embed"].shape, dtype=torch.float32,
                              device=dy.device)
        g_embed.index_add_(0, tokens.reshape(-1), dy.reshape(B * S, -1))
        grads["embed"] = g_embed.to(w["embed"].dtype)
        return nll / n + coef * aux_sum, grads


def pieces(t: torch.Tensor, n: int = 1 << 26):
    """Views of ``t`` along its first dim, each of at most ``n`` elements
    where the first dim allows it (float32 temporaries stay small)."""
    rows = max(1, n // max(1, t[0].numel())) if t.dim() else 1
    if t.dim() == 0:
        return [t]
    return [t[i:i + rows] for i in range(0, t.shape[0], rows)]


def adamw_ref(w, grads, state: dict, *, lr: float, weight_decay: float,
              clip: float, b1: float = 0.9, b2: float = 0.95,
              eps: float = 1e-8):
    """Clip by the global norm, then one AdamW step, in float32 with the
    parameters and moments stored in the leaves' own type, in place, a
    piece of a leaf at a time.  Returns the clipped gradients' norm per
    leaf (float32 tensors)."""
    with torch.no_grad():
        sq = {k: sum(g.float().pow(2).sum() for g in pieces(gr))
              for k, gr in grads.items()}
        total = torch.sqrt(sum(sq.values()))
        scale = torch.clamp(clip / torch.clamp(total, min=1e-9), max=1.0)
        state["scale"] = scale
        state["count"] += 1
        c1 = 1 - b1 ** state["count"]
        c2 = 1 - b2 ** state["count"]
        norms = {}
        for k, gr in grads.items():
            norms[k] = torch.sqrt(sq[k]) * scale
            for p, g, mu, nu in zip(pieces(get_leaf(w, k)), pieces(gr),
                                    pieces(state["mu"][k]),
                                    pieces(state["nu"][k])):
                g32 = g.float() * scale
                m32 = b1 * mu.float() + (1 - b1) * g32
                v32 = b2 * nu.float() + (1 - b2) * g32 * g32
                step = (m32 / c1) / (torch.sqrt(v32 / c2) + eps)
                step = step + weight_decay * p.float()
                p.copy_(p.float() - lr * step)
                mu.copy_(m32)
                nu.copy_(v32)
                del g32, m32, v32, step
        return norms


def get_leaf(w, name: str):
    """Leaf ``name`` (``embed``, ``blocks.0.mixer.wq`` …) of the tree."""
    if name.startswith("blocks.0."):
        return _leaf(w, name[len("blocks.0."):])
    return w[name]
