"""Data pipeline, training-data side (port of ``repro.data.pipeline``).

* :class:`SyntheticTokenDataset` — deterministic synthetic LM batches
  (step ``i`` is a pure function of (seed, i)), drawn by NumPy exactly as
  the reference draws them, so the two packages see the same batches bit
  for bit;
* :class:`PrefetchLoader` — background-thread prefetch with a bounded
  queue.

Batches are NumPy arrays; the trainer moves them to the device, and
:func:`shard_batch` places one on a DeviceMesh (batch dim over the data
axes).
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np


class SyntheticTokenDataset:
    """Deterministic synthetic next-token-prediction batches.

    Tokens are drawn from a Zipfian unigram distribution
    (``p(t) ∝ 1/(t+1)^a``), so training has a learnable marginal
    (``H(zipf) ≪ log V``) and "loss decreases" measures optimization;
    ``zipf_a=0`` samples uniformly.  ``context_len`` adds the stub
    frontend embeddings of the audio/vision archs."""

    def __init__(self, vocab: int, batch_size: int, seq_len: int, *,
                 seed: int = 0, context_len: int = 0, d_model: int = 0,
                 zipf_a: float = 1.2):
        self.vocab = vocab
        self.batch_size = batch_size
        self.seq_len = seq_len
        self.seed = seed
        self.context_len = context_len
        self.d_model = d_model
        if zipf_a:
            w = 1.0 / np.arange(1, vocab + 1, dtype=np.float64) ** zipf_a
            self._probs = w / w.sum()
        else:
            self._probs = None

    def batch(self, step: int) -> dict:
        rng = np.random.default_rng((self.seed, step))
        shape = (self.batch_size, self.seq_len + 1)
        if self._probs is None:
            toks = rng.integers(0, self.vocab, shape, dtype=np.int32)
        else:
            toks = rng.choice(self.vocab, size=shape,
                              p=self._probs).astype(np.int32)
        out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        if self.context_len:
            out["context"] = rng.standard_normal(
                (self.batch_size, self.context_len, self.d_model)
            ).astype(np.float32)
        return out

    def __iter__(self) -> Iterator[dict]:
        i = 0
        while True:
            yield self.batch(i)
            i += 1


#: queue marker ending the stream — lets a consumer blocked in ``get()``
#: observe producer shutdown instead of hanging forever
_SENTINEL = object()


class PrefetchLoader:
    """Background prefetch with a bounded queue.

    Shutdown contract: the worker only ever blocks in *timed* puts, so it
    observes ``close()`` promptly even when the queue is full; on exit
    (dataset exhausted or ``close()``) it always enqueues a sentinel, so a
    consumer blocked in ``__next__`` wakes up and gets ``StopIteration``
    rather than hanging on an empty queue.
    """

    def __init__(self, dataset, depth: int = 2, put_timeout: float = 0.05):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._done = False
        self._put_timeout = put_timeout

        def worker():
            try:
                for b in dataset:
                    placed = False
                    while not self._stop.is_set():
                        try:
                            self._q.put(b, timeout=self._put_timeout)
                            placed = True
                            break
                        except queue.Full:
                            continue
                    if not placed:
                        return  # close() requested while queue stayed full
            finally:
                # Always terminate the stream.  After close() with a full
                # queue, make room by dropping buffered batches (the
                # consumer is gone); without close(), back off while a slow
                # consumer may still drain.
                wait = self._put_timeout
                while True:
                    try:
                        self._q.put(_SENTINEL, timeout=wait)
                        return
                    except queue.Full:
                        if self._stop.is_set():
                            try:
                                self._q.get_nowait()
                            except queue.Empty:
                                pass
                        else:
                            wait = min(wait * 2, 1.0)

        self._t = threading.Thread(target=worker, daemon=True)
        self._t.start()

    def __iter__(self):
        return self

    def __next__(self):
        if self._done:
            raise StopIteration
        item = self._q.get()
        if item is _SENTINEL:
            self._done = True
            raise StopIteration
        return item

    def close(self, timeout: float = 5.0):
        """Stop the worker; safe to call repeatedly / with a blocked consumer."""
        self._stop.set()
        self._t.join(timeout)


def shard_batch(batch: dict, mesh, batch_axes=("pod", "data")) -> dict:
    """Place a host batch of NumPy arrays on ``mesh``: each array becomes a
    DTensor on the mesh's device type with the batch dim sharded over the
    batch axes the mesh has (in the mesh's order), replicated on the
    others (``model``).  Each rank cuts its shard from its own copy of the
    batch: every rank must pass the same batch."""
    import torch
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.parallel.sharding import placements

    axes = tuple(a for a in batch_axes if a in mesh.mesh_dim_names)
    dev = mesh.device_type

    def put(x):
        t = torch.from_numpy(np.ascontiguousarray(x)).to(dev)
        spec = (axes or None, *([None] * (t.dim() - 1)))
        return distribute_tensor(t, mesh, placements(spec, mesh),
                                 src_data_rank=None)

    return {k: put(v) for k, v in batch.items()}
