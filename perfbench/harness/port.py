"""The system under test, as the benchmark reaches it: the PyTorch port
(``repro_torch``, under ``src/`` of the checkout).  Only the drivers
import this module."""

from __future__ import annotations

import sys

from harness.spec import ROOT

_SRC = str(ROOT / "src")
if _SRC not in sys.path:
    sys.path.insert(0, _SRC)

#: the hand-written kernels a model run can launch (built once a checkout)
KERNELS = ("paged_decode", "flash_attention", "moe")


def arch_config(m: dict, name: str):
    """The port's ``ArchConfig`` for a configuration's ``model`` block."""
    from repro_torch.models.config import ArchConfig, LayerSpec

    layer = LayerSpec(mixer="attn", ffn=m["ffn"],
                      rope_fraction=m["rope_fraction"],
                      qk_norm=bool(m.get("qk_norm")))
    kw = dict(name=name, family="moe" if m["ffn"] == "moe" else "dense",
              source="perfbench", d_model=m["d_model"],
              n_heads=m["n_heads"], n_kv_heads=m["n_kv_heads"],
              head_dim=m["head_dim"], d_ff=m["d_ff"], vocab=m["vocab"],
              pattern=(layer,), repeats=m["n_layers"],
              rope_theta=m["rope_theta"])
    if m["ffn"] == "moe":
        kw.update(moe_experts=m["n_experts"], moe_top_k=m["top_k"],
                  moe_d_ff=m["d_ff"],
                  moe_capacity_factor=m["capacity_factor"])
    cfg = ArchConfig(**kw)
    cfg.validate()
    return cfg


def build_kernels(device) -> None:
    """Compile (first run of a checkout) or find the kernels' libraries
    in the checkout's build directory, and load them."""
    if getattr(device, "type", str(device)) != "cuda":
        return
    from repro_torch.kernels import _build

    _build.build_all(KERNELS)
    for k in KERNELS:
        _build.load(k)
