"""Share (%) of the window that the tier placer's re-pins added: over the
steps that re-pinned, the step's time less the median step's, from the
program's step times."""

import statistics


def read(ctx):
    c = getattr(ctx, "ctr", None)
    if not c or not c["repin_steps"]:
        return None
    med = statistics.median(c["step_times"])
    extra = sum(c["step_times"][i] - med for i in c["repin_steps"])
    return 100.0 * extra / c["wall_s"]
