"""Device time of train.clip and train.optimizer over the device time of the whole train.step spans in the traced slice (%), from the program's spans."""

from harness import obs_spans


def read(ctx):
    return obs_spans.optimizer_share(ctx)
