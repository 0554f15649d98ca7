"""Build the port's CUDA kernels with ``nvcc`` at first use and load them
with ``ctypes``.

Each ``csrc/<name>.cu`` becomes its own shared library with a plain C
interface, compiled for Hopper (``sm_90a``) into ``_build/`` beside this
file (listed in ``.gitignore``).  The file name carries a hash of that
kernel's own ``.cu``, the shared ``.cuh`` headers and the flags, so an
edited source is rebuilt, an unchanged one is loaded as it is, and an
edit of one kernel never rebuilds another.  :func:`build_all` starts one
``nvcc`` per kernel, all at once.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: nvcc's output (``-Xptxas -v``: registers, shared memory, spills) of
#: the last build of each kernel in this process
BUILD_LOG: dict[str, str] = {}
_LIBS: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [os.path.join(cuda_home, "bin", "nvcc")] if cuda_home else []
    candidates += [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for c in candidates:
        if c and os.path.exists(c):
            return c
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH and "
        "/usr/local/cuda/bin); the CUDA kernels build only where the CUDA "
        "toolkit is installed")


def _library_path(name: str) -> Path:
    h = hashlib.sha256()
    for src in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    h.update(name.encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all(names) -> dict[str, Path]:
    """Compile every kernel of ``names`` whose library is missing, one
    ``nvcc`` process per kernel, all started together; raise with nvcc's
    output if any build fails.  Returns each kernel's library path."""
    paths = {n: _library_path(n) for n in names}
    procs = {}
    for n, path in paths.items():
        if path.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(f".tmp{os.getpid()}.so")
        procs[n] = (tmp, subprocess.Popen(
            [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for n, (tmp, proc) in procs.items():
        BUILD_LOG[n] = proc.communicate()[0]
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"nvcc failed on {n}.cu (exit {proc.returncode}):"
                          f"\n{BUILD_LOG[n]}")
        else:
            os.replace(tmp, paths[n])         # atomic: no half-written .so
    if failed:
        raise RuntimeError("\n".join(failed))
    return paths


def build(name: str) -> Path:
    """Compile kernel ``name`` unless its library exists."""
    return build_all([name])[name]


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name`` (built first if missing)."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = _LIBS[name] = ctypes.CDLL(str(build(name)))
    return lib


def refuse_autograd(name: str, *tensors, reason: str) -> None:
    """Raise when a kernel's launcher is called where autograd would
    record it: the launch leaves an output without a ``grad_fn``, which
    would be a silently wrong gradient.  ``reason`` says where the
    gradient comes from instead.  The plain versions stay differentiable
    through ordinary autograd."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in tensors if t.is_floating_point()):
        raise RuntimeError(
            f"{name} does not record a gradient: {reason}; call it under "
            "torch.no_grad() or use the plain version for gradients")
