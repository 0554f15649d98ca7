"""Milliseconds a push of the window took on the pusher thread, from the
table's push telemetry (the slowest shard's summed op time over the
pushes)."""


def read(ctx):
    c = getattr(ctx, "ctr", None)
    if not c or not c["pushes"]:
        return None
    return 1e3 * c["push_s"] / c["pushes"]
