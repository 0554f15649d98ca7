"""Bound of the flash forward calls of the prefills over their device time (%), in the traced slice."""

from harness import readers


def read(ctx):
    return readers.roofline_flash_fwd(ctx)
