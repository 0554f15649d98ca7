"""Share (%) of the window in which the training loop waited for rows the
async client had not pulled yet: over the steps, the time from one
step's end to the next's less the step's own time, from the program's
step times."""


def read(ctx):
    c = getattr(ctx, "ctr", None)
    if not c or not c["step_ts"]:
        return None
    ts, took = c["step_ts"], c["step_times"]
    wait = sum(t - (ts[i - 1] if i else 0.0) - d
               for i, (t, d) in enumerate(zip(ts, took)))
    return 100.0 * wait / c["wall_s"]
