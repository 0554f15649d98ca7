"""Input shapes (assigned) and fake-tensor stand-ins for the dry run (port
of ``repro.launch.specs``).

:func:`input_specs` returns the step function of an (arch × shape) pair,
its arguments as fake tensors at their global shapes (``FakeTensorMode``:
shapes and dtypes only, so nothing is allocated for the full configs),
the DTensor placements of each argument on the mesh, and the arguments
the step updates in place (the reference's donated ones).
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs import get_config
from repro_torch.launch import steps as steps_mod
from repro_torch.models import decoder as dec
from repro_torch.models.config import ArchConfig
from repro_torch.optim import adamw_init
from repro_torch.parallel import sharding as shd
from repro_torch.tree import tree_map

#: Gemma-2 global-attention KV cap used for the 500k decode
GLOBAL_ATTN_CAP_500K = 32768


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}


def supports(cfg: ArchConfig, shape_name: str) -> bool:
    """long_500k needs sub-quadratic attention (SSM/hybrid/sliding-window)."""
    if shape_name == "long_500k":
        return cfg.supports_long_context
    return True


def fake_mode():
    """A ``FakeTensorMode`` for templates and traces (plain tensors made
    inside a traced step, such as positions, may meet its fakes)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    return FakeTensorMode(allow_non_fake_inputs=True)


def _context(cfg: ArchConfig, batch: int, device):
    if cfg.encoder is not None:
        n = cfg.encoder.frames
    elif cfg.cross_kv_len:
        n = cfg.cross_kv_len
    else:
        return None
    return torch.empty((batch, n, cfg.d_model), dtype=torch.float32,
                       device=device)


def param_templates(cfg: ArchConfig, *, mode=None, device="cpu"):
    """(params, AdamW state) of ``cfg`` as fake tensors: the port's own
    ``init_model`` and ``adamw_init`` run under ``mode`` (a new
    :func:`fake_mode` by default)."""
    with mode or fake_mode():
        params = dec.init_model(cfg, device=device)
        return params, adamw_init(params)


def _placements(spec_tree, template, mesh):
    return tree_map(lambda _, s: shd.placements(s, mesh), template, spec_tree)


def input_specs(arch: str | ArchConfig, shape_name: str, mesh, *,
                mode=None, device="cpu"):
    """→ (step, args, placements, donate).

    ``step`` is what the launcher runs for this (arch × shape):
    ``train_step`` / ``prefill_step`` / ``serve_step`` of
    :mod:`repro_torch.launch.steps`; ``args`` its arguments (fake tensors
    of ``mode`` at global shapes on ``device``; the decode index is a
    Python int, the new token's position ``seq_len - 1``); ``placements``
    a tree like ``args`` of DTensor placement tuples (None for the int);
    ``donate`` the indices of the arguments the step updates in place."""
    cfg = get_config(arch) if isinstance(arch, str) else arch
    shape = SHAPES[shape_name]
    if not supports(cfg, shape_name):
        raise ValueError(f"{cfg.name} does not support {shape_name} "
                         "(full attention at 524k)")
    mode = mode or fake_mode()
    B, S = shape.global_batch, shape.seq_len
    params_t, opt_t = param_templates(cfg, mode=mode, device=device)
    p_pl = _placements(shd.param_specs(params_t, cfg, mesh), params_t, mesh)

    with mode:
        if shape.kind in ("train", "prefill"):
            batch_t = {"tokens": torch.empty((B, S), dtype=torch.int32,
                                             device=device)}
            if shape.kind == "train":
                batch_t["labels"] = torch.empty((B, S), dtype=torch.int32,
                                                device=device)
            ctx = _context(cfg, B, device)
            if ctx is not None:
                batch_t["context"] = ctx
            b_pl = _placements(shd.batch_specs(batch_t, mesh, batch_size=B),
                               batch_t, mesh)
            if shape.kind == "train":
                step = steps_mod.make_train_step(
                    cfg, microbatch=cfg.train_microbatch)
                o_pl = _placements(shd.param_specs(opt_t, cfg, mesh), opt_t,
                                   mesh)
                # params and the AdamW state are updated in place
                return (step, (params_t, opt_t, batch_t),
                        (p_pl, o_pl, b_pl), (0, 1))
            step = steps_mod.make_prefill_step(cfg)
            return step, (params_t, batch_t), (p_pl, b_pl), ()

        # decode: one new token against a seq_len cache
        cap = GLOBAL_ATTN_CAP_500K if shape_name == "long_500k" else None
        cache_t = dec.init_cache(cfg, B, S, global_cap=cap, device=device)
        token_t = torch.empty((B, 1), dtype=torch.int32, device=device)
        c_pl = _placements(shd.cache_specs(cache_t, cfg, mesh, batch_size=B),
                           cache_t, mesh)
        t_pl = shd.placements(
            shd.batch_specs({"t": token_t}, mesh, batch_size=B)["t"], mesh)
        step = steps_mod.make_serve_step(cfg)
        # the cache is updated in place
        return (step, (params_t, token_t, cache_t, S - 1),
                (p_pl, t_pl, c_pl, None), (2,))
