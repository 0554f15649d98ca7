"""Checkpoint save/restore for parameter/optimizer trees (port of
``repro.checkpoint.io``).

The layout is the reference's: a flat ``arrays.npz`` of leaves keyed by
their path in ``{"params": ..., "opt": ...}`` — dict keys by name,
tuple/list entries and :class:`~repro_torch.optim.OptState`'s fields
(``mu``, ``nu``, ``count``) by index, joined with ``/`` — and a
``manifest.json`` (step, sorted keys, metadata).  So each package loads
the other's checkpoints.  Leaves are written as NumPy arrays on the host;
a bfloat16 leaf is written as float32 (NumPy has no bfloat16) and cast
back to its template's dtype on load.

Crash consistency: with ``atomic=True`` (default) the checkpoint is
staged into a ``<path>.tmp-<pid>`` sibling and published with a single
``os.replace``; :func:`write_pointer` publishes a ``LATEST``-style
pointer the same way.  ``extra_arrays`` rides named NumPy arrays beside
the trees; :func:`load_extra_arrays` returns them.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
from typing import Any

import numpy as np
import torch

from repro_torch.tree import tree_unflatten

#: extra_arrays keys get this prefix inside arrays.npz so they can never
#: collide with a params/opt keypath
_EXTRA = "extra//"


def _items(tree, prefix: str = ""):
    """(key path, leaf) pairs in the reference's key format."""
    if isinstance(tree, dict):
        kids = ((str(k), tree[k]) for k in sorted(tree))
    elif isinstance(tree, (tuple, list)):
        kids = ((str(i), t) for i, t in enumerate(tree))
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        kids = ((str(i), getattr(tree, f.name))
                for i, f in enumerate(dataclasses.fields(tree)))
    else:
        yield prefix, tree
        return
    for k, t in kids:
        yield from _items(t, f"{prefix}/{k}" if prefix else k)


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy()
    return np.asarray(leaf)


def _flatten(tree) -> dict[str, np.ndarray]:
    return {k: _to_numpy(v) for k, v in _items(tree)}


def save_checkpoint(path: str, *, params, opt_state=None, step: int = 0,
                    metadata: dict | None = None,
                    extra_arrays: dict[str, np.ndarray] | None = None,
                    atomic: bool = True) -> int:
    """Write one checkpoint directory; returns the payload bytes written.

    With ``atomic`` the directory appears at ``path`` fully written or
    not at all (staged under ``<path>.tmp-<pid>`` then ``os.replace``\\ d
    into place, clobbering any previous checkpoint at ``path``)."""
    payload = {"params": params}
    if opt_state is not None:
        payload["opt"] = opt_state
    flat = _flatten(payload)
    for k, v in (extra_arrays or {}).items():
        flat[_EXTRA + k] = np.asarray(v)
    stage = f"{path}.tmp-{os.getpid()}" if atomic else path
    if atomic and os.path.exists(stage):
        shutil.rmtree(stage)
    os.makedirs(stage, exist_ok=True)
    np.savez(os.path.join(stage, "arrays.npz"), **flat)
    manifest = {"step": step, "keys": sorted(flat.keys()),
                "metadata": metadata or {}}
    with open(os.path.join(stage, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=2)
    if atomic:
        if os.path.exists(path):
            shutil.rmtree(path)
        os.replace(stage, path)
    return sum(v.nbytes for v in flat.values())


def load_manifest(path: str) -> dict:
    with open(os.path.join(path, "manifest.json")) as f:
        return json.load(f)


def load_checkpoint(path: str, *, params_template, opt_template=None
                    ) -> tuple[Any, Any, int]:
    """Restore into the structure of the given templates (shape-checked;
    each leaf takes its template's dtype and device).  Returns
    (params, opt_state or None, step)."""
    manifest = load_manifest(path)
    payload = {"params": params_template}
    if opt_template is not None:
        payload["opt"] = opt_template
    leaves = []
    with np.load(os.path.join(path, "arrays.npz")) as data:
        for key, leaf in _items(payload):
            arr = data[key]
            if tuple(arr.shape) != tuple(leaf.shape):
                raise ValueError(f"{key}: checkpoint {arr.shape} != "
                                 f"template {tuple(leaf.shape)}")
            leaves.append(torch.from_numpy(np.array(arr, copy=True)).to(
                device=leaf.device, dtype=leaf.dtype))
    restored = tree_unflatten(payload, leaves)
    return restored["params"], restored.get("opt"), manifest["step"]


def load_extra_arrays(path: str) -> dict[str, np.ndarray]:
    """The ``extra_arrays`` companion payload, prefix stripped."""
    with np.load(os.path.join(path, "arrays.npz")) as data:
        return {k[len(_EXTRA):]: data[k] for k in data.files
                if k.startswith(_EXTRA)}


def write_pointer(root: str, target: str, *, name: str = "LATEST") -> None:
    """Atomically point ``root/name`` at a checkpoint directory name
    (relative to ``root``)."""
    os.makedirs(root, exist_ok=True)
    tmp = os.path.join(root, f".{name}.tmp-{os.getpid()}")
    with open(tmp, "w") as f:
        f.write(target + "\n")
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, os.path.join(root, name))


def read_pointer(root: str, *, name: str = "LATEST") -> str | None:
    """Resolve ``root/name`` to a checkpoint path (None if the pointer or
    its target does not exist yet)."""
    ptr = os.path.join(root, name)
    if not os.path.exists(ptr):
        return None
    with open(ptr) as f:
        target = f.read().strip()
    path = os.path.join(root, target)
    return path if target and os.path.isdir(path) else None
