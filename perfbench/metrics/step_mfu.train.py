"""Forward and backward model FLOPs of the window's training sequences over the window, as a share (%) of 989 TFLOP/s (recomputation not counted)."""

from harness import readers


def read(ctx):
    return readers.step_mfu_train(ctx)
