"""Production and smoke meshes as ``torch.distributed`` DeviceMeshes (port
of ``repro.launch.mesh``).

Functions only: importing this module touches no process group.  A mesh
needs a default process group whose world size is the mesh's size.  When
none exists a function creates one only when the caller names its
``backend``:

* ``"nccl"`` / ``"gloo"`` — a real group of world size 1 on an
  in-process ``HashStore`` (only the 1×1 smoke mesh fits one process);
* ``"fake"`` — ``torch.distributed``'s fake backend at the mesh's size
  (rank 0 of 256 or 512): collectives return at once and move nothing,
  which is what the dry run traces against.

``device_type`` is explicit (``cuda`` by default), as the port's entry
points run on the card unless the caller asks for the CPU.
"""

from __future__ import annotations

import datetime

import torch
import torch.distributed as dist

#: axis names and sizes of the production meshes (the reference's)
POD_SHAPE = (16, 16)
POD_AXES = ("data", "model")
MULTI_POD_SHAPE = (2, 16, 16)
MULTI_POD_AXES = ("pod", "data", "model")
#: how long a collective (or the rendezvous) may wait before it fails
PG_TIMEOUT = datetime.timedelta(seconds=60)


def ensure_process_group(backend: str | None, world_size: int) -> None:
    """Make sure a default process group of ``world_size`` ranks exists.

    An existing group must have that size.  Without one, ``backend=None``
    raises; otherwise a group of that backend is created at rank 0 (see
    the module docstring)."""
    if dist.is_initialized():
        if dist.get_world_size() != world_size:
            raise RuntimeError(
                f"the default process group has {dist.get_world_size()} "
                f"ranks; this mesh needs {world_size}")
        return
    if backend is None:
        raise RuntimeError(
            f"no process group: start one of {world_size} ranks, or pass "
            "backend= ('nccl' or 'gloo' for one rank, 'fake' for a dry run)")
    if backend == "fake":
        from torch.testing._internal.distributed.fake_pg import FakeStore

        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=world_size, timeout=PG_TIMEOUT)
        return
    if world_size != 1:
        raise ValueError(f"backend {backend!r} in one process gives one rank; "
                         f"this mesh needs {world_size}")
    dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                            world_size=1, timeout=PG_TIMEOUT)


def close_process_group() -> None:
    """Destroy the default process group (and every subgroup), if any."""
    if dist.is_initialized():
        dist.destroy_process_group()


def make_mesh(shape: tuple[int, ...], axes: tuple[str, ...], *,
              device_type: str = "cuda", backend: str | None = None):
    """A DeviceMesh of ``shape`` with named ``axes`` over ranks
    ``0 .. prod(shape)-1`` in row-major order."""
    from torch.distributed.device_mesh import init_device_mesh

    size = 1
    for n in shape:
        size *= n
    ensure_process_group(backend, size)
    if device_type == "cuda" and backend != "fake":
        torch.cuda.set_device(dist.get_rank() % max(
            torch.cuda.device_count(), 1))
    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda",
                         backend: str | None = None):
    """16×16 = 256 devices per pod; ``multi_pod`` adds the 2-pod axis.

    Axes: ``data`` (batch / FSDP), ``model`` (tensor / expert / vocab),
    ``pod`` (pure data parallelism across pods).  On H100 hosts of 8 GPUs
    a 16-wide axis spans two hosts (see :mod:`repro_torch.roofline`)."""
    shape = MULTI_POD_SHAPE if multi_pod else POD_SHAPE
    axes = MULTI_POD_AXES if multi_pod else POD_AXES
    return make_mesh(shape, axes, device_type=device_type, backend=backend)


def make_smoke_mesh(*, device_type: str = "cuda",
                    backend: str | None = None):
    """1×1 (``data``, ``model``) mesh over the one device."""
    return make_mesh((1, 1), POD_AXES, device_type=device_type,
                     backend=backend)
