"""Random weights from the seed, made on the device in the type they are
served in, one call per leaf (each leaf stacked over the layers).

The tree is laid out as the port's ``params=`` argument takes it
(``embed``, ``lm_head``, ``final_norm`` and ``blocks``: a one-element
tuple whose leaves carry a leading layer axis).  The plain reference
reads the same tensors by the same names.  Each leaf has a generator of
its own, seeded from (run seed, leaf index), so any one leaf can be made
again alone: the training judge remakes the initial weights after the
window instead of keeping a copy through it.
"""

from __future__ import annotations

import math

import numpy as np
import torch

_SEED_MASK = (1 << 64) - 1


def padded_vocab(vocab: int) -> int:
    return -(-vocab // 256) * 256


def leaf_specs(m: dict) -> list[tuple[str, tuple[int, ...], str, float]]:
    """(dotted name, shape, kind, scale) of every leaf, in a fixed order;
    kind ``normal`` is N(0, scale²), ``norm`` is 1 + scale·N(0, 1)."""
    R, d, H, KV, hd = (m["n_layers"], m["d_model"], m["n_heads"],
                       m["n_kv_heads"], m["head_dim"])
    vp = padded_vocab(m["vocab"])
    s_d = 1.0 / math.sqrt(d)
    out = [
        ("embed", (vp, d), "normal", s_d),
        ("lm_head", (d, vp), "normal", s_d),
        ("final_norm", (d,), "norm", 0.1),
        ("blocks.0.norm1", (R, d), "norm", 0.1),
        ("blocks.0.mixer.wq", (R, d, H * hd), "normal", s_d),
        ("blocks.0.mixer.wk", (R, d, KV * hd), "normal", s_d),
        ("blocks.0.mixer.wv", (R, d, KV * hd), "normal", s_d),
        ("blocks.0.mixer.wo", (R, H * hd, d), "normal",
         1.0 / math.sqrt(H * hd)),
    ]
    if m.get("qk_norm"):
        out += [("blocks.0.mixer.q_norm", (R, hd), "norm", 0.1),
                ("blocks.0.mixer.k_norm", (R, hd), "norm", 0.1)]
    out.append(("blocks.0.norm2", (R, d), "norm", 0.1))
    f = m["d_ff"]
    if m["ffn"] == "moe":
        E = m["n_experts"]
        out += [("blocks.0.ffn.router", (R, d, E), "normal", s_d),
                ("blocks.0.ffn.w1", (R, E, d, f), "normal", s_d),
                ("blocks.0.ffn.w3", (R, E, d, f), "normal", s_d),
                ("blocks.0.ffn.w2", (R, E, f, d), "normal",
                 1.0 / math.sqrt(f))]
    else:
        out += [("blocks.0.ffn.w1", (R, d, f), "normal", s_d),
                ("blocks.0.ffn.w3", (R, d, f), "normal", s_d),
                ("blocks.0.ffn.w2", (R, f, d), "normal", 1.0 / math.sqrt(f))]
    return out


def _leaf_seed(seed: int, index: int) -> int:
    ss = np.random.SeedSequence([seed & _SEED_MASK, 7919, index])
    return int(ss.generate_state(1, np.uint64)[0])


def make_leaf(m: dict, seed: int, name: str, *, device, dtype):
    """Leaf ``name`` of the weights of ``seed``."""
    for i, (n, shape, kind, scale) in enumerate(leaf_specs(m)):
        if n == name:
            gen = torch.Generator(device=device)
            gen.manual_seed(_leaf_seed(seed, i))
            t = torch.randn(shape, generator=gen, device=device, dtype=dtype)
            t.mul_(scale)
            if kind == "norm":
                t.add_(1.0)
            return t
    raise KeyError(name)


def set_path(tree: dict, name: str, value) -> None:
    keys = name.split(".")
    node = tree
    for k in keys[:-1]:
        if k == "0":
            continue
        node = node.setdefault(k, {})
    node[keys[-1]] = value


def get_path(tree, name: str):
    node = tree
    for k in name.split("."):
        node = node[int(k)] if k.isdigit() else node[k]
    return node


def make(m: dict, seed: int, *, device, dtype=torch.bfloat16) -> dict:
    """The whole weight tree of ``seed``."""
    flat: dict = {}
    for name, *_ in leaf_specs(m):
        set_path(flat, name, make_leaf(m, seed, name, device=device,
                                       dtype=dtype))
    block = flat.pop("blocks")
    flat["blocks"] = (block,)
    return flat


def dtype_of(m: dict) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float16": torch.float16,
            "float32": torch.float32}[m["dtype"]]
