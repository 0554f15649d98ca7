"""Milliseconds in serve.prefill spans per thousand prompt tokens prefilled."""

from harness import readers


def read(ctx):
    return readers.prefill_ms_per_ktok(ctx)
