"""Arch configs of the port (``--arch <id>``).

Each ported module exports ``config()`` (the full-size config) and
``reduced()`` (a small variant of the same family for CPU tests), with
the same numbers as the reference's ``repro/configs``: all ten of its
archs (attention, MoE, the recurrent ``rwkv6-7b``, the hybrid
``jamba-v0.1-52b``, the encoder-decoder ``whisper-large-v3`` and the
cross-attention ``llama-3.2-vision-11b``).
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
    "jamba-v0.1-52b": "jamba_v0_1_52b",
    "llama-3.2-vision-11b": "llama_3_2_vision_11b",
    "llama3.2-1b": "llama3_2_1b",
    "olmoe-1b-7b": "olmoe_1b_7b",
    "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
    "rwkv6-7b": "rwkv6_7b",
    "whisper-large-v3": "whisper_large_v3",
}


def get_config(arch_id: str, *, reduced: bool = False):
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(ARCH_IDS)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")
    cfg = mod.reduced() if reduced else mod.config()
    cfg.validate()
    return cfg
