"""Device time of every moe.route span (the forward's and the remat recompute's) over the device time of the whole train.step spans in the traced slice (%), from the program's spans."""

from harness import obs_spans


def read(ctx):
    return obs_spans.moe_route_share(ctx)
