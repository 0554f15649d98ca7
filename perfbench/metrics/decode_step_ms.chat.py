"""Host-clock ms per decode step (the entry point's decode_s over decode_steps), chat cell."""

from harness import readers


def read(ctx):
    return readers.decode_step_ms(ctx)
