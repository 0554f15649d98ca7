"""Model FLOPs of the prefills over the time in serve.prefill spans, as a share (%) of 989 TFLOP/s."""

from harness import readers


def read(ctx):
    return readers.step_mfu_prefill(ctx)
