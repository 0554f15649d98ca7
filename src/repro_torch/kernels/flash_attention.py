"""Flash attention: the plain PyTorch version, the wrappers of the CUDA
kernels and the autograd Function that ties their forward and backward
together (port of ``repro.kernels.flash_attention`` and
``repro.kernels.ref.flash_attention_ref``).

q, k, v are ``(B, H, S, hd)`` with the KV heads already expanded to H.
Logits are scaled by ``1/sqrt(hd)``, optionally soft-capped
(``cap·tanh(s/cap)``) and masked by *index* — causal (``r >= c``) and/or
a sliding window (``r - c < window``) — with ``-1e30``, not ``-inf``, so
a row whose keys are all masked averages V uniformly.

* :func:`flash_attention_ref` — direct softmax attention, the CPU path
  and the reference the kernels are held against; differentiable by
  ordinary autograd;
* :func:`flash_fwd_cuda`, :func:`flash_bwd_dkdv_cuda`,
  :func:`flash_bwd_dq_cuda` — the three entry points of
  ``csrc/flash_attention.cu`` (CUDA tensors only), each with a
  ``launches`` count.  Each launches through a ``torch.library`` custom
  op (``repro_torch::flash_fwd`` / ``flash_bwd_dkdv`` / ``flash_bwd_dq``)
  with a fake implementation and a FLOP formula, so a trace over fake
  tensors (the dry run) records the kernel without launching it;
* :class:`FlashAttention` / :func:`flash_attention_cuda` — forward and
  backward both through the kernels.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch
from torch import Tensor
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import _build

NEG_INF = -1e30

# --------------------------------------------------------------------------
# the plain version
# --------------------------------------------------------------------------


def flash_attention_ref(q, k, v, *, causal: bool = True,
                        window: int | None = None,
                        softcap: float | None = None):
    """q, k, v: (B, H, S, hd) → (B, H, Sq, hd) in q's dtype.  Direct
    softmax attention in float32."""
    Sq, hd = q.shape[2], q.shape[3]
    Sk = k.shape[2]
    scale = 1.0 / math.sqrt(hd)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    qpos = torch.arange(Sq, device=q.device)[:, None]
    kpos = torch.arange(Sk, device=q.device)[None, :]
    ok = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        ok = ok & (qpos >= kpos)
    if window is not None:
        ok = ok & ((qpos - kpos) < window)
    s = torch.where(ok, s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", w, v.float()).to(q.dtype)


# --------------------------------------------------------------------------
# the CUDA kernels' wrappers
# --------------------------------------------------------------------------

#: head dims the kernels are built for
KERNEL_HEAD_DIMS = (32, 64, 128, 256)
_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_FNS = None


def _kernel_fns():
    global _FNS
    if _FNS is None:
        lib = _build.load("flash_attention")
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        tail = [i32] * 6 + [f32, f32, i32, ptr]
        lib.flash_fwd.argtypes = [ptr] * 5 + tail
        lib.flash_bwd_dkdv.argtypes = [ptr] * 9 + tail
        lib.flash_bwd_dq.argtypes = [ptr] * 7 + tail
        for fn in (lib.flash_fwd, lib.flash_bwd_dkdv, lib.flash_bwd_dq):
            fn.restype = i32
        lib.flash_error_string.argtypes = [i32]
        lib.flash_error_string.restype = ctypes.c_char_p
        _FNS = lib
    return _FNS


def _refuse_autograd(name: str, *tensors) -> None:
    _build.refuse_autograd(
        name, *tensors,
        reason="its gradient comes from FlashAttention (kernels.ops."
               "flash_attention), which launches the backward kernels")


def _check(name: str, q, k, v, *rows) -> None:
    """q (and each of ``rows``: o, dO) (B,H,Sq,hd); k, v (B,H,Sk,hd); one
    dtype, one device, contiguous, a head dim the kernels are built for."""
    tensors = (q, k, v, *rows)
    if not all(t.is_cuda for t in tensors):
        raise ValueError(f"{name} takes CUDA tensors only")
    if len({t.device for t in tensors}) != 1:
        raise ValueError(f"{name}: tensors on different devices")
    if q.dtype not in _KERNEL_DTYPES or any(t.dtype != q.dtype
                                             for t in tensors):
        raise ValueError(f"{name}: q, k, v need one dtype, float32 or "
                         f"bfloat16; got {[t.dtype for t in tensors]}")
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4:
        raise ValueError(f"{name}: expected q (B,H,Sq,hd), k and v "
                         f"(B,H,Sk,hd); got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, H, Sq, hd = q.shape
    if k.shape[:2] != (B, H) or k.shape[3] != hd or any(
            t.shape != q.shape for t in rows):
        raise ValueError(f"{name}: shapes disagree: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, "
                         f"{[tuple(t.shape) for t in rows]}")
    if hd not in KERNEL_HEAD_DIMS:
        raise ValueError(f"{name}: head_dim {hd} not in {KERNEL_HEAD_DIMS}")
    if min(B * H, Sq, k.shape[2]) < 1 or B * H > 65535:
        raise ValueError(f"{name}: B·H = {B * H} must be in [1, 65535] and "
                         "the sequences non-empty")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: tensors must be contiguous")
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"{name}: tensors must be 16-byte aligned (the "
                         "backward copies 16-byte chunks)")


def _mask_args(q, causal, window, softcap):
    if window is not None and window < 1:
        raise ValueError(f"flash attention: window {window} < 1")
    B, H, Sq, hd = q.shape
    return (B * H, Sq, hd, int(bool(causal)), window or 0,
            float(softcap or 0.0), 1.0 / math.sqrt(hd),
            _KERNEL_DTYPES[q.dtype])


def _launch(name: str, fn, q, *ptrs_and_ints):
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(*ptrs_and_ints, stream)
    if err != 0:
        raise RuntimeError(
            f"{name} kernel launch failed at q {tuple(q.shape)} {q.dtype}: "
            f"{_kernel_fns().flash_error_string(err).decode()} "
            f"(cudaError {err})")


def flash_fwd_cuda(q, k, v, *, causal: bool = True,
                   window: int | None = None, softcap: float | None = None):
    """Launch the forward kernel: returns ``(o, lse)`` with o (B,H,Sq,hd)
    in q's dtype and lse (B,H,Sq) float32, the per-row log-sum-exp the
    backward needs.  Same math as :func:`flash_attention_ref`; contiguous
    CUDA tensors only.  ``flash_fwd_cuda.launches`` counts the launches."""
    _refuse_autograd("flash_fwd_cuda", q, k, v)
    return _flash_fwd(q, k, v, causal, window, softcap)


flash_fwd_cuda.launches = 0


@torch.library.custom_op("repro_torch::flash_fwd", mutates_args=())
def _flash_fwd(q: Tensor, k: Tensor, v: Tensor, causal: bool,
               window: int | None, softcap: float | None
               ) -> tuple[Tensor, Tensor]:
    _check("flash_fwd_cuda", q, k, v)
    BH, Sq, hd, c, w, cap, scale, dt = _mask_args(q, causal, window,
                                                  softcap)
    o = torch.empty_like(q)
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    _launch("flash_fwd", _kernel_fns().flash_fwd, q, q.data_ptr(),
            k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(), BH,
            Sq, k.shape[2], hd, c, w, cap, scale, dt)
    flash_fwd_cuda.launches += 1
    return o, lse


@_flash_fwd.register_fake
def _(q, k, v, causal, window, softcap):
    return torch.empty_like(q), q.new_empty(q.shape[:3],
                                            dtype=torch.float32)


def flash_bwd_dkdv_cuda(q, k, v, o, lse, do, *, causal: bool = True,
                        window: int | None = None,
                        softcap: float | None = None):
    """Launch the first backward pass: ``D = rowsum(dO ∘ o)``, then dK and
    dV (one block per key tile, looping over the query tiles that see
    it).  Returns ``(dk, dv, delta)``; ``delta`` (B,H,Sq) float32 feeds
    :func:`flash_bwd_dq_cuda`.  ``flash_bwd_dkdv_cuda.launches`` counts
    the launches."""
    _refuse_autograd("flash_bwd_dkdv_cuda", q, k, v, o, do)
    return _flash_bwd_dkdv(q, k, v, o, lse, do, causal, window, softcap)


flash_bwd_dkdv_cuda.launches = 0


@torch.library.custom_op("repro_torch::flash_bwd_dkdv", mutates_args=())
def _flash_bwd_dkdv(q: Tensor, k: Tensor, v: Tensor, o: Tensor, lse: Tensor,
                    do: Tensor, causal: bool, window: int | None,
                    softcap: float | None) -> tuple[Tensor, Tensor, Tensor]:
    _check("flash_bwd_dkdv_cuda", q, k, v, o, do)
    _check_lse(lse, q)
    BH, Sq, hd, c, w, cap, scale, dt = _mask_args(q, causal, window,
                                                  softcap)
    delta = torch.empty_like(lse)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch("flash_bwd_dkdv", _kernel_fns().flash_bwd_dkdv, q, q.data_ptr(),
            k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            BH, Sq, k.shape[2], hd, c, w, cap, scale, dt)
    flash_bwd_dkdv_cuda.launches += 1
    return dk, dv, delta


@_flash_bwd_dkdv.register_fake
def _(q, k, v, o, lse, do, causal, window, softcap):
    return torch.empty_like(k), torch.empty_like(v), torch.empty_like(lse)


def flash_bwd_dq_cuda(q, k, v, do, lse, delta, *, causal: bool = True,
                      window: int | None = None,
                      softcap: float | None = None):
    """Launch the second backward pass: dQ (one block per query tile,
    looping over its key tiles), from the ``delta`` of
    :func:`flash_bwd_dkdv_cuda`.  ``flash_bwd_dq_cuda.launches`` counts
    the launches."""
    _refuse_autograd("flash_bwd_dq_cuda", q, k, v, do)
    return _flash_bwd_dq(q, k, v, do, lse, delta, causal, window, softcap)


flash_bwd_dq_cuda.launches = 0


@torch.library.custom_op("repro_torch::flash_bwd_dq", mutates_args=())
def _flash_bwd_dq(q: Tensor, k: Tensor, v: Tensor, do: Tensor, lse: Tensor,
                  delta: Tensor, causal: bool, window: int | None,
                  softcap: float | None) -> Tensor:
    _check("flash_bwd_dq_cuda", q, k, v, do)
    _check_lse(lse, q)
    _check_lse(delta, q)
    BH, Sq, hd, c, w, cap, scale, dt = _mask_args(q, causal, window,
                                                  softcap)
    dq = torch.empty_like(q)
    _launch("flash_bwd_dq", _kernel_fns().flash_bwd_dq, q, q.data_ptr(),
            k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), dq.data_ptr(), BH, Sq, k.shape[2], hd, c, w,
            cap, scale, dt)
    flash_bwd_dq_cuda.launches += 1
    return dq


@_flash_bwd_dq.register_fake
def _(q, k, v, do, lse, delta, causal, window, softcap):
    return torch.empty_like(q)


def attended_pairs(Sq: int, Sk: int, causal: bool,
                   window: int | None) -> int:
    """Query-key pairs that the index mask keeps: row r attends keys c
    with ``c <= r`` (causal) and ``r - c < window``."""
    if not causal and not window:
        return Sq * Sk
    r = np.arange(Sq, dtype=np.int64)            # NumPy: no fake tensors
    hi = np.minimum(r, Sk - 1) if causal else np.full_like(r, Sk - 1)
    lo = np.maximum(r - window + 1, 0) if window else np.zeros_like(r)
    return int(np.maximum(hi - lo + 1, 0).sum())


def _flash_kernel_flops(q_shape, k_shape, products: int, causal,
                        window) -> int:
    """``products`` hd-long dot products per attended pair, two FLOPs per
    multiply-add."""
    B, H, Sq, hd = q_shape
    return 2 * products * hd * B * H * attended_pairs(Sq, k_shape[2],
                                                      causal, window)


@register_flop_formula(torch.ops.repro_torch.flash_fwd)
def _(q_shape, k_shape, v_shape, causal, window, softcap, *args,
      **kwargs) -> int:
    """QKᵀ and PV: 4·hd FLOPs per attended pair."""
    return _flash_kernel_flops(q_shape, k_shape, 2, causal, window)


@register_flop_formula(torch.ops.repro_torch.flash_bwd_dkdv)
def _(q_shape, k_shape, v_shape, o_shape, lse_shape, do_shape, causal,
      window, softcap, *args, **kwargs) -> int:
    """QKᵀ again, dOVᵀ, PᵀdO and dSᵀQ: 8·hd FLOPs per pair."""
    return _flash_kernel_flops(q_shape, k_shape, 4, causal, window)


@register_flop_formula(torch.ops.repro_torch.flash_bwd_dq)
def _(q_shape, k_shape, v_shape, do_shape, lse_shape, delta_shape, causal,
      window, softcap, *args, **kwargs) -> int:
    """QKᵀ again, dOVᵀ and dS·K: 6·hd FLOPs per pair."""
    return _flash_kernel_flops(q_shape, k_shape, 3, causal, window)


def _check_lse(t, q) -> None:
    if (t.dtype != torch.float32 or t.shape != q.shape[:3]
            or not t.is_contiguous() or t.device != q.device):
        raise ValueError(f"flash backward: lse/delta must be contiguous "
                         f"float32 {tuple(q.shape[:3])} on {q.device}; got "
                         f"{t.dtype} {tuple(t.shape)} on {t.device}")


class FlashAttention(torch.autograd.Function):
    """Flash attention whose forward and backward are both kernels: the
    forward saves q, k, v, o and the row log-sum-exp; the backward runs
    the dK/dV pass and then the dQ pass.  Deterministic: neither pass
    uses atomics, so a gradient is the same from run to run."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        o, lse = flash_fwd_cuda(q, k, v, causal=causal, window=window,
                                softcap=softcap)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.mask = {"causal": causal, "window": window, "softcap": softcap}
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        do = do.contiguous()
        dk, dv, delta = flash_bwd_dkdv_cuda(q, k, v, o, lse, do, **ctx.mask)
        dq = flash_bwd_dq_cuda(q, k, v, do, lse, delta, **ctx.mask)
        return dq, dk, dv, None, None, None


def flash_attention_cuda(q, k, v, *, causal: bool = True,
                         window: int | None = None,
                         softcap: float | None = None):
    """Differentiable flash attention through the kernels (CUDA tensors,
    q/k/v (B,H,S,hd), any strides: they are made contiguous)."""
    return FlashAttention.apply(q, k, v, causal, window, softcap)
