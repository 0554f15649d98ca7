"""Bound of the MoE dispatch and combine calls over their device time (%), in the traced slice."""

from harness import readers


def read(ctx):
    return readers.roofline_moe(ctx)
