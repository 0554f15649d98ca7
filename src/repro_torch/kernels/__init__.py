"""Hand-written Hopper kernels of the port, their plain PyTorch versions
and the dispatch between them (``ops``).  Kernel sources live in
``csrc/`` and are built with ``nvcc`` at first use (``_build``)."""

from repro_torch.kernels.paged_attention import PagePool

__all__ = ["PagePool"]
