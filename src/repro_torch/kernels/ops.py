"""Dispatch between the port's CUDA kernels and their plain versions
(port of ``repro.kernels.ops``).

``impl="auto"`` launches the kernel for CUDA tensors and runs the plain
PyTorch version for CPU tensors — the choice follows the device the data
lies on, never whether a GPU was found.  A failed build or launch raises;
nothing falls back.
"""

from __future__ import annotations

from repro_torch.kernels import moe as moe_k
from repro_torch.kernels import paged_attention as paged_k


def paged_attention_decode(q, k_pages, v_pages, page_table, q_pos, *,
                           window: int | None = None,
                           softcap: float | None = None,
                           impl: str = "auto"):
    """Paged one-token decode attention.  q: (B, KV, G, hd) grouped
    queries; k/v_pages: (num_pages, page_size, KV, hd); page_table:
    (B, P) int32; q_pos: (B,) int32.  Returns (B, KV, G, hd).

    ``auto``: the CUDA kernel (:func:`paged_k.paged_decode_cuda`) for
    CUDA tensors, the gather (:func:`paged_k.paged_decode_gather`) for
    CPU tensors.  ``gather`` forces the plain version on any device;
    ``cuda`` forces the kernel and raises for CPU tensors.  The dense
    ring-buffer oracle is ``nn.attention.decode_attention``
    (``ArchConfig.kv_impl="dense"``), not a kernels-layer path."""
    if impl not in ("auto", "gather", "cuda"):
        raise ValueError(f"unknown paged-attention impl {impl!r}: expected "
                         "auto/gather/cuda")
    if impl == "gather" or (impl == "auto" and not q.is_cuda):
        return paged_k.paged_decode_gather(q, k_pages, v_pages, page_table,
                                           q_pos, window=window,
                                           softcap=softcap)
    if not q.is_cuda:
        raise ValueError("impl='cuda' needs CUDA tensors; q lies on "
                         f"{q.device}")
    return paged_k.paged_decode_cuda(q, k_pages, v_pages, page_table, q_pos,
                                     window=window, softcap=softcap)


def _moe_impl(impl: str, t) -> str:
    """Resolve the MoE impl for data ``t``: ``auto`` launches the kernel
    for CUDA tensors and takes the slot version for CPU tensors."""
    if impl == "auto":
        return "cuda" if t.is_cuda else "slot"
    if impl not in ("slot", "cuda"):
        raise ValueError(
            f"unknown MoE impl {impl!r}: the port offers auto/slot/cuda "
            "(the TPU's interpret/pallas paths are the CUDA kernels here, "
            "and the scatter/gather oracle is nn.moe.moe_ffn's impl='ref', "
            "not a kernels-layer path)")
    if impl == "cuda" and not t.is_cuda:
        raise ValueError(f"impl='cuda' needs CUDA tensors; the data lies on "
                         f"{t.device}")
    return impl


def moe_dispatch(x, eid, pos, wtok, *, num_experts: int, capacity: int,
                 top_k: int, impl: str = "auto"):
    """Capacity-slab dispatch (G,S,D) → (G,E,C,D).

    eid/pos: ``(G, S·K)`` int32 routing; wtok: ``(G, S·K)`` per-(token,k)
    weight (the keep mask in the model; pairs with weight 0 claim no
    slot).  ``auto``: the CUDA kernel (:func:`moe_k.moe_dispatch_cuda`)
    for CUDA tensors, the slot gather (:func:`moe_k.dispatch_slot`) for
    CPU tensors; ``slot`` forces the plain version, ``cuda`` the kernel."""
    impl = _moe_impl(impl, x)
    slot_nk = moe_k.slot_maps(eid, pos, wtok != 0, num_experts=num_experts,
                              capacity=capacity)
    slot_src = moe_k.slot_sources(slot_nk, top_k=top_k)
    slot_w = moe_k.slot_weights(slot_nk, wtok)
    if impl == "cuda":
        return moe_k.moe_dispatch_cuda(x.contiguous(), slot_src, slot_w)
    return moe_k.dispatch_slot(x, slot_src, slot_w)


def moe_combine(buf, eid, pos, w, *, impl: str = "auto"):
    """Gate-weighted combine (G,E,C,D) → (G,S,D); eid/pos/w: (G, S, K).
    Same ``impl`` choices as :func:`moe_dispatch`."""
    if _moe_impl(impl, buf) == "cuda":
        return moe_k.moe_combine_cuda(buf, eid, pos, w)
    return moe_k.combine_slot(buf, eid, pos, w)
