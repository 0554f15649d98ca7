"""Share (%) of the rows the window pulled that the hot cache on the card
served, from the table's pull telemetry."""


def read(ctx):
    c = getattr(ctx, "ctr", None)
    if not c or not c["pull_rows"]:
        return None
    return 100.0 * c["pull_hot_rows"] / c["pull_rows"]
