"""Model FLOPs of every prompt and served token over the window's wall time, as a share (%) of 989 TFLOP/s."""

from harness import readers


def read(ctx):
    return readers.step_mfu_window(ctx)
