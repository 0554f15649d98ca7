"""Device time of the layer.* spans under train.backward (what remat recomputes) over the device time of the whole train.step spans in the traced slice (%), from the program's spans."""

from harness import obs_spans


def read(ctx):
    return obs_spans.recompute_share(ctx)
