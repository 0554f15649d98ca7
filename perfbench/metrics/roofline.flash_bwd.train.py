"""Bound of the flash backward calls (dK/dV and dQ) over their kernels' device time (%), in the traced slice."""

from harness import readers


def read(ctx):
    return readers.roofline_flash_bwd(ctx)
