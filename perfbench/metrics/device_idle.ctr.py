"""Share (%) of the traced slice of a CTR window with no device operation running."""

from harness import readers


def read(ctx):
    return readers.device_idle_pct(ctx)
