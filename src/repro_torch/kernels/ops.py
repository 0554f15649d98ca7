"""Dispatch between the port's CUDA kernels and their plain versions
(port of ``repro.kernels.ops``).

``impl="auto"`` launches the kernel for CUDA tensors and runs the plain
PyTorch version for CPU tensors — the choice follows the device the data
lies on, never whether a GPU was found.  A failed build or launch raises;
nothing falls back.
"""

from __future__ import annotations

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
