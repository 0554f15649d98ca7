"""MoE capacity-slab dispatch and combine: routing metadata, plain PyTorch
versions and the wrappers of the CUDA kernels (port of
``repro.kernels.moe``).

GShard-style MoE moves every routed token row twice: into its expert's
``(E, C)`` capacity slab before the expert matmuls (dispatch) and back,
gate-weighted, after them (combine).  The routing *metadata* — which
(token, k) pair fills which slot — is computed once with integer tensor
ops (:func:`slot_maps`, :func:`slot_sources`, :func:`slot_weights`),
with no device→host sync, so a decode step stays free of them.  The
D-wide row movement has two implementations each:

* :func:`dispatch_slot` / :func:`combine_slot` — plain PyTorch gathers,
  the CPU path and the reference the kernels are held against
  (:func:`combine_slot_ordered` sums in the kernel's order, for bit-exact
  checks);
* :func:`moe_dispatch_cuda` / :func:`moe_combine_cuda` — the hand-written
  Hopper kernels of ``csrc/moe.cu``, CUDA tensors only.

Gradients through the kernels come from the autograd Functions
:class:`MoeDispatch` and :class:`MoeCombine`, as the reference's
``custom_vjp`` defines them: dispatch is linear in x and its transpose is
combine, and combine's transpose (for the slab) is dispatch, so each
backward launches the *other* kernel; combine's gate gradient is a
gather-dot in PyTorch, as the reference leaves it to XLA.  The raw
launchers refuse autograd; the plain versions are differentiable as they
stand.
"""

from __future__ import annotations

import ctypes

import torch
from torch import Tensor

from repro_torch.kernels import _build

# --------------------------------------------------------------------------
# routing metadata (integer ops, shared by every impl)
# --------------------------------------------------------------------------


def slot_maps(eid, pos, keep, *, num_experts: int, capacity: int):
    """Invert the token→slot routing into per-slot source maps.

    eid, pos, keep: ``(G, NK)`` — expert id, position-in-expert and keep
    mask per (token, k) pair, with ``NK = S·K`` and source token
    ``s = nk // K``.  Returns ``slot_nk (G, E, C) int32`` — the flat
    (token, k) index claiming each slot, ``-1`` for empty slots.

    Kept pairs have unique (expert, position) slots; dropped pairs are
    steered to an extra column ``C`` of an ``(E, C+1)`` slab, which is
    sliced off — the reference's ``mode="drop"`` scatter without a
    data-dependent shape."""
    G, NK = eid.shape
    E, C = num_experts, capacity
    dev = eid.device
    col = torch.where(keep & (pos < C), pos, C).long()
    rows = torch.arange(G, device=dev)[:, None].expand(G, NK)
    nk = torch.arange(NK, dtype=torch.int32, device=dev).expand(G, NK)
    slab = torch.full((G, E, C + 1), -1, dtype=torch.int32, device=dev)
    slab.index_put_((rows, eid.long(), col), nk)
    return slab[:, :, :C].contiguous()


def slot_sources(slot_nk, *, top_k: int):
    """slot_nk ``(G, E, C)`` flat (token,k) ids → token row ids (−1 kept)."""
    return torch.where(slot_nk >= 0, slot_nk // top_k, -1).to(torch.int32)


def slot_weights(slot_nk, wtok):
    """Scatter per-(token,k) weights ``wtok (G, NK)`` onto the slots.

    Empty slots get weight 0, which is what makes the ``max(src, 0)``
    row-select of the dispatch safe."""
    G = wtok.shape[0]
    safe = slot_nk.clamp_min(0).reshape(G, -1).long()
    w = torch.gather(wtok, 1, safe).reshape(slot_nk.shape)
    return torch.where(slot_nk >= 0, w, 0.0).to(wtok.dtype)


def dispatch_slots(eid, pos, wtok, *, num_experts: int, capacity: int,
                   top_k: int):
    """(slot_src, slot_w) of the (G, S·K) routing, as dispatch takes
    them: pairs with weight 0 claim no slot."""
    slot_nk = slot_maps(eid, pos, wtok != 0, num_experts=num_experts,
                        capacity=capacity)
    return slot_sources(slot_nk, top_k=top_k), slot_weights(slot_nk, wtok)


# --------------------------------------------------------------------------
# plain PyTorch versions (the CPU path and the kernels' reference)
# --------------------------------------------------------------------------


def dispatch_slot(x, slot_src, slot_w):
    """Gather-formulated dispatch: slab row = slot_w · x[slot_src].

    x: (G, S, D); slot_src/slot_w: (G, E, C) → (G, E, C, D) in x's dtype.
    Empty slots (src −1) read row 0 with weight 0, and every source
    index is clamped into ``[0, S-1]`` as a JAX gather clamps it."""
    G, S, _ = x.shape
    rows = torch.arange(G, device=x.device)[:, None, None]
    src = slot_src.long().clamp(0, S - 1)
    return x[rows, src] * slot_w[..., None].to(x.dtype)


def combine_slot(buf, eid, pos, w):
    """Gather + gate-weighted sum over k (the kernel's math).

    buf: (G, E, C, D); eid/pos/w: (G, S, K) → (G, S, D) in buf's dtype;
    ``eid``/``pos`` are clamped into the slab as a JAX gather clamps."""
    G, E, C, _ = buf.shape
    rows = torch.arange(G, device=buf.device)[:, None, None]
    picked = buf[rows, eid.long().clamp(0, E - 1), pos.long().clamp(0, C - 1)]
    return (picked * w[..., None].to(buf.dtype)).sum(dim=2)


def combine_slot_ordered(buf, eid, pos, w):
    """:func:`combine_slot` with the kernel's rounding: the sum over k runs
    in k order into a float32 accumulator that starts at 0, one rounded
    product and one rounded add a step, and is cast to buf's dtype once
    (``combine_slot``'s ``.sum(dim=2)`` promises no order).  The CUDA
    kernel's float32 result is bit-equal to it."""
    G, E, C, _ = buf.shape
    rows = torch.arange(G, device=buf.device)[:, None, None]
    picked = buf[rows, eid.long().clamp(0, E - 1),
                 pos.long().clamp(0, C - 1)].float()       # (G, S, K, D)
    w = w.float()
    acc = torch.zeros_like(picked[:, :, 0])
    for k in range(eid.shape[-1]):
        acc = acc + picked[:, :, k] * w[:, :, k, None]
    return acc.to(buf.dtype)


# --------------------------------------------------------------------------
# the CUDA kernels' wrappers
# --------------------------------------------------------------------------

_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_FNS = None


def _kernel_fns():
    global _FNS
    if _FNS is None:
        lib = _build.load("moe")
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.moe_dispatch.argtypes = [ptr] * 4 + [i32] * 6 + [ptr]
        lib.moe_dispatch.restype = i32
        lib.moe_combine.argtypes = ([ptr] * 5 + [i32] * 6
                                    + [ctypes.c_longlong] * 3 + [i32, ptr])
        lib.moe_combine.restype = i32
        lib.moe_error_string.argtypes = [i32]
        lib.moe_error_string.restype = ctypes.c_char_p
        _FNS = (lib.moe_dispatch, lib.moe_combine, lib.moe_error_string)
    return _FNS


def _check_tensors(name: str, data, ints, floats, *,
                   strided_data: bool = False) -> None:
    """``strided_data``: ``data`` may be any view whose last axis is
    contiguous (the kernel reads it through its strides)."""
    tensors = (data, *ints, *floats)
    if not all(t.is_cuda for t in tensors):
        raise ValueError(f"{name} takes CUDA tensors only")
    if len({t.device for t in tensors}) != 1:
        raise ValueError(f"{name}: tensors on different devices")
    if data.dtype not in _KERNEL_DTYPES:
        raise ValueError(f"{name}: data dtype {data.dtype} is not float32 "
                         "or bfloat16")
    if any(t.dtype != torch.int32 for t in ints):
        raise ValueError(f"{name}: index tensors must be int32")
    dense = (*ints, *floats) if strided_data else tensors
    if not all(t.is_contiguous() for t in dense) or (
            strided_data and data.stride(-1) != 1):
        raise ValueError(f"{name}: tensors must be contiguous"
                         + (" (the data along its last axis)"
                            if strided_data else ""))


def _refuse_autograd(name: str, *tensors) -> None:
    _build.refuse_autograd(
        name, *tensors,
        reason="its gradient comes from MoeDispatch / MoeCombine "
               "(kernels.ops.moe_dispatch / moe_combine), which launch the "
               "other kernel as the backward")


def _launched(name: str, err: int, shape) -> None:
    if err != 0:
        raise RuntimeError(
            f"{name} kernel launch failed at shape {tuple(shape)}: "
            f"{_kernel_fns()[2](err).decode()} (cudaError {err})")


def moe_dispatch_cuda(x, slot_src, slot_w):
    """Launch the Hopper dispatch kernel (``csrc/moe.cu``).

    Same contract as :func:`dispatch_slot` (x float32 or bfloat16,
    ``slot_src`` int32; ``slot_w`` is taken in float32, as the TPU
    kernel takes it), with the product formed in float32 and cast once.
    CUDA tensors only; raises on anything the kernel does not take, when
    the launch is refused, and under autograd (:class:`MoeDispatch` is the
    differentiable form).  ``moe_dispatch_cuda.launches`` counts the
    launches.  The launch goes through the custom op
    ``repro_torch::moe_dispatch``, whose fake implementation lets a trace
    over fake tensors record it."""
    _refuse_autograd("moe_dispatch_cuda", x, slot_src, slot_w)
    return _moe_dispatch(x, slot_src, slot_w.to(torch.float32))


moe_dispatch_cuda.launches = 0


@torch.library.custom_op("repro_torch::moe_dispatch", mutates_args=())
def _moe_dispatch(x: Tensor, slot_src: Tensor, slot_w: Tensor) -> Tensor:
    _check_tensors("moe_dispatch_cuda", x, (slot_src,), (slot_w,))
    if x.dim() != 3 or slot_src.dim() != 3 or slot_w.shape != slot_src.shape:
        raise ValueError(
            "moe_dispatch_cuda: expected x (G,S,D), slot_src/slot_w "
            f"(G,E,C); got {tuple(x.shape)}, {tuple(slot_src.shape)}, "
            f"{tuple(slot_w.shape)}")
    G, S, D = x.shape
    _, E, C = slot_src.shape
    if slot_src.shape[0] != G or min(G, S, D, E, C) < 1:
        raise ValueError(f"moe_dispatch_cuda: shapes disagree or are empty: "
                         f"x {tuple(x.shape)}, slots {tuple(slot_src.shape)}")
    fn = _kernel_fns()[0]
    out = torch.empty((G, E, C, D), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), slot_src.data_ptr(), slot_w.data_ptr(),
                 out.data_ptr(), G, S, E, C, D, _KERNEL_DTYPES[x.dtype],
                 stream)
    _launched("moe_dispatch", err, out.shape)
    moe_dispatch_cuda.launches += 1
    return out


@_moe_dispatch.register_fake
def _(x, slot_src, slot_w):
    G, E, C = slot_src.shape
    return x.new_empty((G, E, C, x.shape[2]))


def moe_combine_cuda(buf, eid, pos, w):
    """Launch the Hopper combine kernel (``csrc/moe.cu``).

    Same contract as :func:`combine_slot` (buf float32 or bfloat16,
    ``eid``/``pos`` int32; ``w`` is taken in float32, as the TPU kernel
    takes it), summing over k in order into a float32 accumulator and
    casting once.  ``buf`` may be a strided view (the expert product's
    permuted output) as long as its D axis is contiguous.  CUDA tensors
    only; raises on anything the kernel does not take, when the launch is
    refused, and under autograd (:class:`MoeCombine` is the differentiable
    form).  ``moe_combine_cuda.launches`` counts the launches, through the
    custom op ``repro_torch::moe_combine`` as for dispatch."""
    _refuse_autograd("moe_combine_cuda", buf, eid, pos, w)
    return _moe_combine(buf, eid, pos, w.to(torch.float32))


moe_combine_cuda.launches = 0


@torch.library.custom_op("repro_torch::moe_combine", mutates_args=())
def _moe_combine(buf: Tensor, eid: Tensor, pos: Tensor, w: Tensor) -> Tensor:
    _check_tensors("moe_combine_cuda", buf, (eid, pos), (w,),
                   strided_data=True)
    if buf.dim() != 4 or eid.dim() != 3 or not (
            eid.shape == pos.shape == w.shape):
        raise ValueError(
            "moe_combine_cuda: expected buf (G,E,C,D), eid/pos/w (G,S,K); "
            f"got {tuple(buf.shape)}, {tuple(eid.shape)}, "
            f"{tuple(pos.shape)}, {tuple(w.shape)}")
    G, E, C, D = buf.shape
    _, S, K = eid.shape
    if eid.shape[0] != G or min(G, E, C, D, S, K) < 1:
        raise ValueError(f"moe_combine_cuda: shapes disagree or are empty: "
                         f"buf {tuple(buf.shape)}, eid {tuple(eid.shape)}")
    fn = _kernel_fns()[1]
    out = torch.empty((G, S, D), dtype=buf.dtype, device=buf.device)
    with torch.cuda.device(buf.device):
        stream = torch.cuda.current_stream(buf.device).cuda_stream
        err = fn(buf.data_ptr(), eid.data_ptr(), pos.data_ptr(), w.data_ptr(),
                 out.data_ptr(), G, S, K, E, C, D, *buf.stride()[:3],
                 _KERNEL_DTYPES[buf.dtype], stream)
    _launched("moe_combine", err, out.shape)
    moe_combine_cuda.launches += 1
    return out


@_moe_combine.register_fake
def _(buf, eid, pos, w):
    G, S, _ = eid.shape
    return buf.new_empty((G, S, buf.shape[3]))


# --------------------------------------------------------------------------
# autograd through the kernels (reference: moe.py custom_vjp pair)
# --------------------------------------------------------------------------


class MoeDispatch(torch.autograd.Function):
    """Dispatch (G,S,D) → (G,E,C,D) through the dispatch kernel, with the
    combine kernel as its backward: ``dx[s] = Σ_k wtok[s,k]·dbuf[eid, pos]``
    over the kept pairs (dropped pairs' ``pos`` is clamped to slot 0;
    their weight is 0).  ``wtok`` (the keep mask in the model) is a
    constant of the routing: its gradient is zero."""

    @staticmethod
    def forward(ctx, x, eid, pos, wtok, num_experts, capacity, top_k):
        src, sw = dispatch_slots(eid, pos, wtok, num_experts=num_experts,
                                 capacity=capacity, top_k=top_k)
        ctx.save_for_backward(eid, pos, wtok)
        ctx.x_shape = x.shape
        return moe_dispatch_cuda(x.contiguous(), src, sw)

    @staticmethod
    def backward(ctx, dbuf):
        eid, pos, wtok = ctx.saved_tensors
        G, S, _ = ctx.x_shape
        K = eid.shape[1] // S
        dx = None
        if ctx.needs_input_grad[0]:
            safe_pos = torch.where(wtok != 0, pos, 0).to(torch.int32)
            if dbuf.stride(-1) != 1:        # the kernel reads rows whole
                dbuf = dbuf.contiguous()
            dx = moe_combine_cuda(dbuf,
                                  eid.reshape(G, S, K).contiguous(),
                                  safe_pos.reshape(G, S, K).contiguous(),
                                  wtok.reshape(G, S, K).contiguous())
        dw = torch.zeros_like(wtok) if ctx.needs_input_grad[3] else None
        return dx, None, None, dw, None, None, None


class MoeCombine(torch.autograd.Function):
    """Combine (G,E,C,D) → (G,S,D) through the combine kernel.  Backward:
    the slab's gradient is the dispatch kernel applied to dy with the kept
    pairs' weights (``dbuf[e,c] = w[s,k]·dy[s]`` for the slot's owner), and
    ``dw[s,k] = ⟨dy[s], buf[eid,pos]⟩`` over the kept pairs, a gather-dot
    in PyTorch (the reference computes it in XLA, outside its kernels)."""

    @staticmethod
    def forward(ctx, buf, eid, pos, w):
        ctx.save_for_backward(buf, eid, pos, w)
        return moe_combine_cuda(buf, eid, pos, w)

    @staticmethod
    def backward(ctx, dy):
        buf, eid, pos, w = ctx.saved_tensors
        G, E, C, _ = buf.shape
        _, S, K = eid.shape
        keep = w != 0
        dy = dy.contiguous()
        dbuf = dw = None
        if ctx.needs_input_grad[0]:
            wtok = torch.where(keep, w, 0.0).reshape(G, S * K)
            src, sw = dispatch_slots(eid.reshape(G, S * K),
                                     pos.reshape(G, S * K), wtok,
                                     num_experts=E, capacity=C, top_k=K)
            dbuf = moe_dispatch_cuda(dy, src, sw).to(buf.dtype)
        if ctx.needs_input_grad[3]:
            rows = torch.arange(G, device=buf.device)[:, None, None]
            picked = buf[rows, eid.long().clamp(0, E - 1),
                         pos.long().clamp(0, C - 1)]           # (G, S, K, D)
            dw = torch.einsum("gskd,gsd->gsk", picked.float(), dy.float())
            dw = torch.where(keep, dw, 0.0).to(w.dtype)
        return dbuf, None, None, dw
