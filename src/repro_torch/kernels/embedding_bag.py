"""Embedding bag — sparse row lookup with sum pooling: the plain PyTorch
version and the wrapper of the CUDA kernel (port of
``repro.kernels.embedding_bag``).

``(N, bag)`` ids into a ``(V, dim)`` table give ``(N, dim)``: each output
row is the sum of the bag's table rows, taken in float32 and cast to the
table's dtype once.  Ids are clamped into ``[0, V-1]``, as a clamping
gather clamps them.

* :func:`embedding_bag_ref` — plain PyTorch: the CPU path and the
  reference the kernel is held against;
* :func:`embedding_bag_cuda` — the hand-written Hopper kernel
  ``csrc/embedding_bag.cu``, CUDA tensors only.

With ``bag = 1`` the sum is ``0 + row``, so the lookup is exact: the CTR
path (``ps/sharding.py``) runs its one-row-per-id gathers of the hot-row
cache and the oracle's storage through it.  The kernel has no backward:
on that path the row gradients come from the dense tower, and the
launcher refuses autograd.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_FNS = None


def embedding_bag_ref(ids, table):
    """ids ``(N, bag)`` integer, table ``(V, dim)`` → ``(N, dim)`` in the
    table's dtype: the bag's rows (ids clamped into the table) summed in
    float32."""
    V = table.shape[0]
    rows = table[ids.long().clamp(0, V - 1)]
    return rows.to(torch.float32).sum(dim=1).to(table.dtype)


def _kernel_fns():
    global _FNS
    if _FNS is None:
        lib = _build.load("embedding_bag")
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.embedding_bag.argtypes = [ptr] * 3 + [ctypes.c_longlong] + \
            [i32] * 4 + [ptr]
        lib.embedding_bag.restype = i32
        lib.embedding_bag_error_string.argtypes = [i32]
        lib.embedding_bag_error_string.restype = ctypes.c_char_p
        _FNS = (lib.embedding_bag, lib.embedding_bag_error_string)
    return _FNS


def embedding_bag_cuda(ids, table):
    """Launch the Hopper embedding-bag kernel (``csrc/embedding_bag.cu``).

    Same contract as :func:`embedding_bag_ref`: ``ids (N, bag)`` int32
    (int64 is cast once it is checked that the table has fewer than 2³¹
    rows), ``table (V, dim)`` float32 or bfloat16, any N, bag, V and dim.
    CUDA tensors only; raises on anything the kernel does not take, when
    the launch is refused, and under autograd (the kernel has no
    backward).  ``embedding_bag_cuda.launches`` counts the launches."""
    _build.refuse_autograd(
        "embedding_bag_cuda", table,
        reason="the kernel has no backward; on the CTR path the row "
               "gradients come from the dense tower")
    if not (ids.is_cuda and table.is_cuda):
        raise ValueError("embedding_bag_cuda takes CUDA tensors only")
    if ids.device != table.device:
        raise ValueError("embedding_bag_cuda: ids and table on different "
                         f"devices ({ids.device}, {table.device})")
    if ids.dim() != 2 or table.dim() != 2:
        raise ValueError("embedding_bag_cuda: expected ids (N, bag) and "
                         f"table (V, dim); got {tuple(ids.shape)}, "
                         f"{tuple(table.shape)}")
    if table.dtype not in _KERNEL_DTYPES:
        raise ValueError(f"embedding_bag_cuda: table dtype {table.dtype} is "
                         "not float32 or bfloat16")
    N, bag = ids.shape
    V, dim = table.shape
    if min(N, bag, V, dim) < 1:
        raise ValueError(f"embedding_bag_cuda: empty shape: ids "
                         f"{tuple(ids.shape)}, table {tuple(table.shape)}")
    if V >= 2 ** 31 or bag >= 2 ** 31 or dim >= 2 ** 31:
        raise ValueError(f"embedding_bag_cuda: table {tuple(table.shape)} "
                         "or bag too large for int32 indexing")
    if ids.dtype == torch.int64:
        # clamped as the kernel clamps, then exact in int32: V < 2³¹
        ids = ids.clamp(0, V - 1).to(torch.int32)
    if ids.dtype != torch.int32:
        raise ValueError(f"embedding_bag_cuda: ids dtype {ids.dtype} is not "
                         "int32 or int64")
    ids, table = ids.contiguous(), table.contiguous()
    fn, err_str = _kernel_fns()
    out = torch.empty((N, dim), dtype=table.dtype, device=table.device)
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream(table.device).cuda_stream
        err = fn(ids.data_ptr(), table.data_ptr(), out.data_ptr(), N, bag, V,
                 dim, _KERNEL_DTYPES[table.dtype], stream)
    if err != 0:
        raise RuntimeError(
            f"embedding_bag kernel launch failed at ids {tuple(ids.shape)}, "
            f"table {tuple(table.shape)}: {err_str(err).decode()} "
            f"(cudaError {err})")
    embedding_bag_cuda.launches += 1
    return out


embedding_bag_cuda.launches = 0
