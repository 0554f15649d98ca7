"""Device operations in the traced slice over the whole train.step spans the program recorded there: the launches of one training step."""

from harness import obs_spans


def read(ctx):
    return obs_spans.device_ops_per_step(ctx)
