"""Host-clock ms per decode step (the entry point's decode_s over decode_steps), offline cell."""

from harness import readers


def read(ctx):
    return readers.decode_step_ms(ctx)
