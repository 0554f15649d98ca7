"""Dispatch between the port's CUDA kernels and their plain versions
(port of ``repro.kernels.ops``).

``impl="auto"`` launches the kernel for CUDA tensors and runs the plain
PyTorch version for CPU tensors — the choice follows the device the data
lies on, never whether a GPU was found.  A failed build or launch raises;
nothing falls back.

DTensors (a model on a DeviceMesh) go through ``local_map``: the inputs
are laid out with only the dims the kernel can split kept sharded (the
batch and head dims of attention, the group dim of the MoE, the batch of
a paged decode; everything else replicated), and each rank runs the same
kernel — or, for CPU shards, the same plain version — on its own shard.
"""

from __future__ import annotations

from repro_torch.kernels import embedding_bag as bag_k
from repro_torch.kernels import flash_attention as flash_k
from repro_torch.kernels import moe as moe_k
from repro_torch.kernels import paged_attention as paged_k
from repro_torch.parallel.act import is_dtensor as _is_dtensor


def _layout(t, keep: tuple[int, ...]):
    """``t``'s placements with the shards of dims outside ``keep`` (and
    any pending sum) replaced by replication."""
    from torch.distributed.tensor import Replicate, Shard

    return tuple(p if isinstance(p, Shard) and p.dim in keep else Replicate()
                 for p in t.placements)


def _per_shard(fn, args, in_layouts, *out_layouts):
    """``fn`` on each rank's shards of ``args`` (DTensors, or plain tensors
    taken as replicated) laid out as ``in_layouts``; each result is a
    DTensor laid out as its entry of ``out_layouts``."""
    from torch.distributed.tensor import DTensor, Replicate
    from torch.distributed.tensor.experimental import local_map

    mesh = next(a.device_mesh for a in args if _is_dtensor(a))
    args = [a if _is_dtensor(a) else DTensor.from_local(
        a, mesh, [Replicate()] * mesh.ndim, run_check=False) for a in args]
    return local_map(fn, out_placements=out_layouts,
                     in_placements=tuple(in_layouts),
                     redistribute_inputs=True)(*args)


def flash_attention(q, k, v, *, causal: bool = True,
                    window: int | None = None,
                    softcap: float | None = None, impl: str = "auto"):
    """Blockwise attention, q/k/v (B, H, S, hd) with KV heads expanded →
    (B, H, Sq, hd); differentiable on every path.

    ``auto``: the CUDA kernels (forward and backward,
    :class:`flash_k.FlashAttention`) for CUDA tensors, the plain
    :func:`flash_k.flash_attention_ref` for CPU tensors; ``ref`` forces
    the plain version on any device; ``cuda`` forces the kernels and
    raises for CPU tensors.  Unlike the reference's Pallas kernel, which
    needs Sq and Sk padded up to its 128-row blocks (and so refuses a
    non-causal Sk off the block multiple), the CUDA kernels take any
    lengths: rows and keys past the last full tile do not exist for
    them."""
    if impl not in ("auto", "ref", "cuda"):
        raise ValueError(f"unknown flash-attention impl {impl!r}: expected "
                         "auto/ref/cuda")
    if _is_dtensor(q):                 # batch and heads stay split
        pl = _layout(q, (0, 1))
        return _per_shard(
            lambda a, b, c: flash_attention(a, b, c, causal=causal,
                                            window=window, softcap=softcap,
                                            impl=impl),
            (q, k, v), (pl, pl, pl), pl)
    if impl == "ref" or (impl == "auto" and not q.is_cuda):
        return flash_k.flash_attention_ref(q, k, v, causal=causal,
                                           window=window, softcap=softcap)
    if not q.is_cuda:
        raise ValueError(f"impl='cuda' needs CUDA tensors; q lies on "
                         f"{q.device}")
    return flash_k.flash_attention_cuda(q, k, v, causal=causal,
                                        window=window, softcap=softcap)


def embedding_bag(ids, table, *, impl: str = "auto"):
    """Sum-pooled lookup: ids ``(N, bag)`` into table ``(V, dim)`` →
    ``(N, dim)`` in the table's dtype, summed in float32, ids clamped
    into the table.

    ``auto``: the CUDA kernel (:func:`bag_k.embedding_bag_cuda`) for CUDA
    tensors, the plain :func:`bag_k.embedding_bag_ref` for CPU tensors;
    ``ref`` forces the plain version on any device; ``cuda`` forces the
    kernel and raises for CPU tensors."""
    if impl not in ("auto", "ref", "cuda"):
        raise ValueError(f"unknown embedding-bag impl {impl!r}: expected "
                         "auto/ref/cuda")
    if impl == "ref" or (impl == "auto" and not table.is_cuda):
        return bag_k.embedding_bag_ref(ids, table)
    if not table.is_cuda:
        raise ValueError("impl='cuda' needs CUDA tensors; the table lies on "
                         f"{table.device}")
    return bag_k.embedding_bag_cuda(ids, table)


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
    if _is_dtensor(q):                 # the batch stays split; pools whole
        pl = _layout(q, (0,))
        whole = _layout(k_pages, ())
        return _per_shard(
            lambda *a: paged_attention_decode(*a, window=window,
                                              softcap=softcap, impl=impl),
            (q, k_pages, v_pages, page_table, q_pos),
            (pl, whole, whole, pl, pl), pl)
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
    for CUDA tensors — through :class:`moe_k.MoeDispatch`, whose backward
    is the combine kernel — and the slot gather
    (:func:`moe_k.dispatch_slot`) for CPU tensors; ``slot`` forces the
    plain version, ``cuda`` the kernel.  Differentiable on every path."""
    if _is_dtensor(x):                 # groups stay split
        pl = _layout(x, (0,))
        return _per_shard(
            lambda *a: moe_dispatch(*a, num_experts=num_experts,
                                    capacity=capacity, top_k=top_k,
                                    impl=impl),
            (x, eid, pos, wtok), (pl,) * 4, pl)
    impl = _moe_impl(impl, x)
    if impl == "cuda":
        return moe_k.MoeDispatch.apply(x, eid, pos, wtok, num_experts,
                                       capacity, top_k)
    slot_src, slot_w = moe_k.dispatch_slots(
        eid, pos, wtok, num_experts=num_experts, capacity=capacity,
        top_k=top_k)
    return moe_k.dispatch_slot(x, slot_src, slot_w)


def moe_combine(buf, eid, pos, w, *, impl: str = "auto"):
    """Gate-weighted combine (G,E,C,D) → (G,S,D); eid/pos/w: (G, S, K).
    Same ``impl`` choices as :func:`moe_dispatch`; the kernel path goes
    through :class:`moe_k.MoeCombine`, whose backward is the dispatch
    kernel plus the gate gradient's gather-dot."""
    if _is_dtensor(buf):               # groups stay split
        pl = _layout(buf, (0,))
        return _per_shard(lambda *a: moe_combine(*a, impl=impl),
                          (buf, eid, pos, w), (pl,) * 4, pl)
    if _moe_impl(impl, buf) == "cuda":
        return moe_k.MoeCombine.apply(buf, eid, pos, w)
    return moe_k.combine_slot(buf, eid, pos, w)


def moe_positions(eid, *, capacity: int, num_experts: int,
                  impl: str = "auto"):
    """Position-in-expert of the routing ``eid (G, S·K)``: each pair's
    exclusive rank among its group's earlier pairs of the same expert, as
    ``pos (G, S·K) int32`` and ``keep = pos < capacity`` (bool).

    ``auto``: the CUDA kernel (:func:`moe_k.moe_positions_cuda`) for CUDA
    tensors, the one-hot ``cumsum`` (:func:`moe_k.positions_cumsum`) for
    CPU tensors; ``slot`` forces the plain version, ``cuda`` the kernel.
    Groups are independent, so a DTensor keeps its group dim split."""
    if _is_dtensor(eid):               # groups stay split
        pl = _layout(eid, (0,))
        return _per_shard(
            lambda e: moe_positions(e, capacity=capacity,
                                    num_experts=num_experts, impl=impl),
            (eid,), (pl,), pl, pl)
    if _moe_impl(impl, eid) == "cuda":
        return moe_k.moe_positions_cuda(eid, capacity, num_experts)
    return moe_k.positions_cumsum(eid, capacity=capacity,
                                  num_experts=num_experts)
