"""Bound of the decode-attention calls over the paged-decode kernels' device time (%), in the traced slice."""

from harness import readers


def read(ctx):
    return readers.roofline_paged_decode(ctx)
