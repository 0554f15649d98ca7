"""Crash-consistent unified checkpoints for the elastic PS fleet (port of
``repro.ps.snapshot``).

Replica promotion (:meth:`~repro_torch.ps.elastic.ElasticPSFleet.recover`)
survives *single* failures; a correlated loss — one preempted zone
taking a bucket's primary **and** backup — needs durable state.  This
module drains the fleet into a **unified checkpoint**: per-bucket slabs
+ PS optimizer state + acked-counter watermark, written *alongside* the
dense tower params and the data cursor in one atomic
:mod:`repro_torch.checkpoint.io` directory, so training state can never be
split across two half-written files.

Consistency model:

* :func:`snapshot_fleet` captures under the fleet's lock, after
  finishing any in-flight migrations (a mid-migration capture would
  miss ``buffer_only`` pushes the source primary never saw).  No pull/
  push can interleave, so the capture is a single point on the update
  timeline — its per-bucket ``acked`` counters are the watermark.
* :class:`FleetCheckpointer` drains synchronously (cheap RPCs) but
  writes **asynchronously** in a background thread, so the training
  loop pays snapshot-drain time, not disk time.  The write is staged
  and published by ``os.replace`` + an atomic ``LATEST`` pointer: a
  crash mid-write leaves the previous checkpoint selectable and a
  ``.tmp-`` orphan, never a torn manifest.
* :func:`load_fleet_checkpoint` + :meth:`~repro_torch.ps.elastic.
  ElasticPSFleet.restore_snapshot` reload bit-exactly; replaying the
  (deterministic) batch stream from the checkpoint's cursor then
  reproduces the fault-free loss trajectory bit-for-bit — the
  acceptance pin in ``tests/test_torch_chaos.py``.

The dense params are a tree of tensors (the CTR tower); a restore puts
each leaf on its template's device and dtype, so a tower trained on the
card comes back on the card.
"""

from __future__ import annotations

import os
import re
import shutil
import threading
import time

import numpy as np

from repro_torch import obs
from repro_torch.checkpoint import io as ckpt_io
from repro_torch.obs import trace as obs_trace
from repro_torch.ps.transport import PSShardLost

_STEP_RE = re.compile(r"^step-(\d{8})$")


def _step_name(step: int) -> str:
    return f"step-{step:08d}"


def snapshot_fleet(fleet) -> dict:
    """Drain every bucket's primary into host memory (one consistent
    point: slab rows, optimizer state, acked watermark).

    Holds the fleet lock for the duration, finishing in-flight
    migrations first; a shard lost mid-drain triggers recovery and a
    retry against the promoted replicas (bit-identical by invariant).
    Raises :class:`~repro_torch.ps.elastic.PSUnrecoverable` if recovery is
    impossible — there is nothing consistent left to save.
    """
    with fleet._mu:
        for b in sorted(fleet._migrations):
            fleet.finish_migration(b)
        nb = fleet.spec.num_buckets
        while True:
            msgs = [(int(fleet.primary[b]), {"op": "snapshot", "bucket": b})
                    for b in range(nb)]
            try:
                replies = fleet.transport.request_many(msgs)
                break
            except PSShardLost as e:
                fleet.recover(getattr(e, "shard_ids", None))
        buckets = {
            b: {"rows": rep["rows"], "opt": rep["opt"],
                "acked": int(rep["acked"])}
            for b, rep in enumerate(replies)}
        meta = {"vocab": fleet.spec.vocab, "dim": fleet.spec.dim,
                "num_buckets": nb, "optimizer": fleet.optimizer,
                "hyper": dict(fleet.hyper),
                "acked": [buckets[b]["acked"] for b in range(nb)]}
    return {"buckets": buckets, "meta": meta}


def pack_snapshot(snap: dict) -> dict[str, np.ndarray]:
    """Flatten a fleet snapshot into named arrays for ``extra_arrays``."""
    out: dict[str, np.ndarray] = {}
    for b, st in snap["buckets"].items():
        pre = f"ps/bucket{int(b):05d}/"
        out[pre + "rows"] = np.asarray(st["rows"], np.float32)
        out[pre + "acked"] = np.asarray(int(st["acked"]), np.int64)
        for k, v in st["opt"].items():
            out[pre + "opt/" + k] = np.asarray(v)
    return out


def unpack_snapshot(arrays: dict[str, np.ndarray], meta: dict) -> dict:
    """Inverse of :func:`pack_snapshot` (``meta`` from the manifest)."""
    buckets: dict[int, dict] = {}
    for key, arr in arrays.items():
        if not key.startswith("ps/bucket"):
            continue
        bstr, field = key[len("ps/"):].split("/", 1)
        st = buckets.setdefault(int(bstr[len("bucket"):]),
                                {"rows": None, "opt": {}, "acked": 0})
        if field == "rows":
            st["rows"] = arr
        elif field == "acked":
            st["acked"] = int(arr)
        elif field.startswith("opt/"):
            st["opt"][field[len("opt/"):]] = arr
    return {"buckets": buckets, "meta": dict(meta)}


def save_fleet_checkpoint(root: str, step: int, *, params, snap: dict,
                          metadata: dict | None = None,
                          extra_arrays: dict | None = None,
                          keep: int = 0) -> int:
    """Write ``root/step-<step>/`` atomically, flip ``LATEST``, prune.

    Returns payload bytes.  ``keep > 0`` retains only the newest
    ``keep`` complete steps (pruned *after* the pointer flip, so the
    pointer target always survives)."""
    t0 = time.perf_counter()
    name = _step_name(step)
    arrays = pack_snapshot(snap)
    for k, v in (extra_arrays or {}).items():
        arrays[k] = np.asarray(v)
    snap_meta = dict(snap["meta"])
    snap_meta["step"] = int(step)
    meta = {"ps": snap_meta, **(metadata or {})}
    with obs_trace.span("ps.ckpt.write", "ps", step=step):
        nbytes = ckpt_io.save_checkpoint(
            os.path.join(root, name), params=params, step=step,
            metadata=meta, extra_arrays=arrays, atomic=True)
        ckpt_io.write_pointer(root, name)
        if keep > 0:
            prune_checkpoints(root, keep=keep)
    seconds = time.perf_counter() - t0
    obs.REGISTRY.counter("ps.ckpt.saves").inc()
    obs.REGISTRY.counter("ps.ckpt.bytes").inc(nbytes)
    obs.REGISTRY.counter("ps.ckpt.ms").inc(int(seconds * 1e3))
    if obs_trace.enabled():
        obs_trace.instant("ps.ckpt.saved", "ps", step=step, bytes=nbytes,
                          seconds=round(seconds, 4))
    return nbytes


def list_checkpoints(root: str) -> list[tuple[int, str]]:
    """Complete (published) steps under ``root``, ascending."""
    if not os.path.isdir(root):
        return []
    out = []
    for entry in os.listdir(root):
        m = _STEP_RE.match(entry)
        if m and os.path.isdir(os.path.join(root, entry)):
            out.append((int(m.group(1)), os.path.join(root, entry)))
    return sorted(out)


def prune_checkpoints(root: str, *, keep: int) -> None:
    """Drop all but the newest ``keep`` steps, plus any ``.tmp-`` orphans
    an interrupted save left behind.  Never removes the ``LATEST``
    target."""
    latest = ckpt_io.read_pointer(root)
    steps = list_checkpoints(root)
    for _, path in steps[:-keep] if keep > 0 else []:
        if latest and os.path.samefile(path, latest):
            continue
        shutil.rmtree(path, ignore_errors=True)
    for entry in os.listdir(root) if os.path.isdir(root) else []:
        if ".tmp-" in entry:
            shutil.rmtree(os.path.join(root, entry), ignore_errors=True)


def load_fleet_checkpoint(root: str, *, params_template
                          ) -> tuple[object, dict, int, dict]:
    """Load the newest complete checkpoint: ``(params, snap, step,
    metadata)``.  ``snap`` feeds :meth:`ElasticPSFleet.restore_snapshot`;
    resolution goes through the ``LATEST`` pointer, so an interrupted
    save is never selected."""
    path = ckpt_io.read_pointer(root)
    if path is None:
        steps = list_checkpoints(root)   # pre-pointer fallback
        if not steps:
            raise FileNotFoundError(f"no complete checkpoint under {root}")
        path = steps[-1][1]
    params, _, step = ckpt_io.load_checkpoint(
        path, params_template=params_template)
    manifest = ckpt_io.load_manifest(path)
    extra = ckpt_io.load_extra_arrays(path)
    snap = unpack_snapshot(extra, manifest["metadata"].get("ps", {}))
    return params, snap, step, manifest["metadata"]


class FleetCheckpointer:
    """Periodic async checkpointing of (fleet state + dense params).

    ``maybe_save(step, params)`` fires every ``every`` steps: the fleet
    drain is synchronous (a consistent capture requires the fleet lock)
    but serialization + disk I/O happen on a background writer thread —
    at most one in flight; a new save joins the previous writer first,
    so checkpoints publish in step order.  Call :meth:`wait` before
    reading ``LATEST`` (restore paths do) and :meth:`close` when done.
    """

    def __init__(self, fleet, root: str, *, every: int = 0, keep: int = 2,
                 background: bool = True):
        self.fleet = fleet
        self.root = root
        self.every = int(every)
        self.keep = int(keep)
        self.background = background
        self._writer: threading.Thread | None = None
        self._write_error: BaseException | None = None
        #: (step, bytes) of completed saves, for tests/benchmarks
        self.saved: list[tuple[int, int]] = []

    def maybe_save(self, step: int, params, *, metadata: dict | None = None,
                   extra_arrays: dict | None = None) -> bool:
        if not self.every or (step + 1) % self.every:
            return False
        self.save(step, params, metadata=metadata,
                  extra_arrays=extra_arrays)
        return True

    def save(self, step: int, params, *, metadata: dict | None = None,
             extra_arrays: dict | None = None) -> None:
        self.wait()                       # publish in order, bound memory
        with obs_trace.span("ps.ckpt.drain", "ps", step=step):
            snap = snapshot_fleet(self.fleet)

        def write():
            try:
                nbytes = save_fleet_checkpoint(
                    self.root, step, params=params, snap=snap,
                    metadata=metadata, extra_arrays=extra_arrays,
                    keep=self.keep)
                self.saved.append((step, nbytes))
            except BaseException as e:    # surfaced by the next wait()
                self._write_error = e

        if self.background:
            self._writer = threading.Thread(
                target=write, daemon=True, name="ps-ckpt-writer")
            self._writer.start()
        else:
            write()
            self.wait()

    def wait(self) -> None:
        """Join the in-flight writer; re-raise any write failure (a
        checkpoint that silently failed to persist must not look like
        durability)."""
        w, self._writer = self._writer, None
        if w is not None:
            w.join()
        if self._write_error is not None:
            e, self._write_error = self._write_error, None
            raise RuntimeError("fleet checkpoint write failed") from e

    def close(self) -> None:
        self.wait()
