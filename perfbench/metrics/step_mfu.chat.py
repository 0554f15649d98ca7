"""Model FLOPs of the decoded tokens over the time in serve.decode_chunk spans, as a share (%) of 989 TFLOP/s."""

from harness import readers


def read(ctx):
    return readers.step_mfu_decode(ctx)
