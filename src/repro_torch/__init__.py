"""PyTorch/CUDA port of the ``repro`` package.

The JAX package ``repro`` stays the reference; this package mirrors its
subpackage layout and function names so each part has an obvious
counterpart, and holds against it in ``tests/test_torch_*.py``.  It
imports ``torch`` and never ``jax`` or anything of ``repro``.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
with no GPU and no explicit CPU request they raise (see
:func:`repro_torch.device.resolve_device`).
"""

from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
