"""Arch configs of the port (``--arch <id>``).

Each ported module exports ``config()`` (the full-size config) and
``reduced()`` (a small variant of the same family for CPU tests), with
the same numbers as the reference's ``repro/configs``.  Ported:
every attention arch (``llama3.2-1b``, ``chatglm3-6b``, ``gemma2-2b``,
``internlm2-20b``, ``olmoe-1b-7b``, ``qwen3-moe-30b-a3b``); every other
reference arch id raises ``NotImplementedError`` naming the ROADMAP item
that ports it.
"""

from __future__ import annotations

import importlib

ARCH_IDS = (
    "jamba-v0.1-52b",
    "rwkv6-7b",
    "chatglm3-6b",
    "olmoe-1b-7b",
    "gemma2-2b",
    "internlm2-20b",
    "whisper-large-v3",
    "llama3.2-1b",
    "qwen3-moe-30b-a3b",
    "llama-3.2-vision-11b",
)

_MODULES = {
    "chatglm3-6b": "chatglm3_6b",
    "gemma2-2b": "gemma2_2b",
    "internlm2-20b": "internlm2_20b",
    "llama3.2-1b": "llama3_2_1b",
    "olmoe-1b-7b": "olmoe_1b_7b",
    "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
}

#: where each not-yet-ported arch waits (ROADMAP.md, queue 1)
_PENDING = {
    "jamba-v0.1-52b": "queue 1 item 10 (recurrent and encoder mixers)",
    "rwkv6-7b": "queue 1 item 10 (recurrent and encoder mixers)",
    "whisper-large-v3": "queue 1 item 10 (recurrent and encoder mixers)",
    "llama-3.2-vision-11b": "queue 1 item 10 (recurrent and encoder mixers)",
}


def get_config(arch_id: str, *, reduced: bool = False):
    if arch_id in _PENDING:
        raise NotImplementedError(
            f"arch {arch_id!r} is not ported to repro_torch yet; it waits "
            f"for ROADMAP.md {_PENDING[arch_id]}")
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(ARCH_IDS)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")
    cfg = mod.reduced() if reduced else mod.config()
    cfg.validate()
    return cfg
