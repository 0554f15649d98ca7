"""Parameter-server-style sparse embedding path (HeterPS §3; port of
``repro.parallel.ps``).

The paper keeps huge sparse embedding tables on CPU parameter servers:
workers *pull* only the touched rows, compute, and *push* sparse row
gradients back, without ever forming a dense table gradient.

* :func:`sparse_pull` is plain indexing, so autograd gives the pulled
  rows' gradient;
* :func:`sparse_push`, :func:`segment_rowsum` and :func:`dedup_rows`
  scatter-add rows through :func:`add_rows`, which adds the occurrences
  of one index in stream order on every device — the reference's XLA
  scatter-add order, and what keeps a push bit-exact against the
  shard servers' sequential ``np.add.at`` (``index_add_`` alone sums
  duplicates with atomics on CUDA, in no fixed order);
* :class:`SparseEmbedding` packages them with a row-frequency hook for
  the data-management tier monitor.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device


def occurrence_rank(idx):
    """For a 1-D index tensor, how many earlier entries carry the same
    index (0 for a first occurrence)."""
    n = idx.numel()
    sorted_idx, order = torch.sort(idx, stable=True)
    pos = torch.arange(n, device=idx.device)
    first = torch.ones(n, dtype=torch.bool, device=idx.device)
    first[1:] = sorted_idx[1:] != sorted_idx[:-1]
    start = torch.cummax(torch.where(first, pos, 0), 0).values
    rank = torch.empty_like(pos)
    rank[order] = pos - start
    return rank


def add_rows(dst, idx, src):
    """``dst`` with ``src[i]`` added to row ``idx[i]`` for every i, as a
    new tensor: the occurrences of one index are added in stream order
    (``((dst + s0) + s1) + …``), in rounds of distinct indices, so the
    result does not depend on the device or on atomics."""
    out = dst.clone()
    idx = idx.reshape(-1).long()
    if idx.numel() == 0:
        return out
    src = src.reshape(idx.numel(), *dst.shape[1:]).to(dst.dtype)
    rank = occurrence_rank(idx)
    for r in range(int(rank.max()) + 1):
        sel = rank == r
        out.index_add_(0, idx[sel], src[sel])
    return out


def sparse_pull(table, ids):
    """Pull rows: (V, D)[ids (…,)] → (…, D).  Plain indexing: autograd's
    backward is the sparse push we want, a scatter-add of the touched
    rows' cotangent."""
    return table[ids.long()]


def sparse_push(table, ids, row_grads, *, lr: float):
    """PS push: apply row gradients to the table without a dense grad.
    ids: (N,), row_grads: (N, D).  Returns the new table."""
    return add_rows(table, ids, (-lr * row_grads).to(table.dtype))


def segment_rowsum(ids, row_grads, *, num_rows: int):
    """Aggregate duplicate ids before the push (the PS's reduce step),
    in stream order."""
    zeros = torch.zeros((num_rows, row_grads.shape[-1]),
                        dtype=row_grads.dtype, device=row_grads.device)
    return add_rows(zeros, ids, row_grads)


def dedup_rows(ids, row_grads, *, fill_id: int):
    """Reduce an (ids, row_grads) COO stream to one entry per distinct id.

    Fixed output size, as the reference's: sorted unique ids ``(N,)``
    padded with ``fill_id``, and per-id summed rows ``(N, D)`` (zero rows
    in the padding); duplicates are accumulated in stream order via
    :func:`segment_rowsum`, so a push of the result is bit-identical to a
    dense-table segment sum."""
    ids = ids.reshape(-1)
    n = ids.numel()
    uniq, inv = torch.unique(ids, sorted=True, return_inverse=True)
    uids = torch.full((n,), fill_id, dtype=ids.dtype, device=ids.device)
    uids[:uniq.numel()] = uniq
    return uids, segment_rowsum(inv.reshape(-1), row_grads.reshape(n, -1),
                                num_rows=n)


class SparseEmbedding:
    """Embedding table with PS-style sparse update + access stats.

    The table is drawn from a ``torch.Generator`` seeded by ``seed``
    (``N(0, 1/dim)``) on the CPU and moved to ``device`` (default
    ``cuda``)."""

    def __init__(self, vocab: int, dim: int, seed: int = 0, *,
                 monitor=None, device=None):
        self.vocab = vocab
        self.dim = dim
        g = torch.Generator().manual_seed(seed)
        self.table = (torch.randn((vocab, dim), generator=g)
                      * dim ** -0.5).to(resolve_device(device))
        self.monitor = monitor  # repro_torch.data.cache.AccessMonitor

    def lookup(self, ids):
        if self.monitor is not None:
            self.monitor.record(np.asarray(torch.as_tensor(ids).cpu()))
        return sparse_pull(self.table, torch.as_tensor(
            ids, device=self.table.device))

    def apply_sparse_grads(self, ids, row_grads, *, lr: float,
                           dedup: bool = True):
        """Push row gradients.  With ``dedup`` (default) duplicate ids are
        aggregated once via :func:`dedup_rows` before the scatter, so an
        adaptive optimizer sitting on the PS sees each row exactly once
        per step.  ``dedup=False`` keeps the raw scatter-add of every
        occurrence; for plain SGD the two are an equal row sum up to
        float association."""
        dev = self.table.device
        ids_flat = torch.as_tensor(ids, device=dev).reshape(-1)
        g_flat = torch.as_tensor(row_grads, device=dev).reshape(-1, self.dim)
        if dedup:
            uids, summed = dedup_rows(ids_flat, g_flat, fill_id=self.vocab)
            live = uids < self.vocab          # padding slots drop
            self.table = add_rows(self.table, uids[live],
                                  (-lr * summed[live]).to(self.table.dtype))
        else:
            self.table = sparse_push(self.table, ids_flat, g_flat, lr=lr)
        return self.table
