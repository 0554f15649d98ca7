"""90th percentile over the window's requests of arrival to first token less the request's own prefill span (ms): time spent queued for admission."""

from harness import readers


def read(ctx):
    return readers.queue_wait_p90_ms(ctx)
