"""Mean host time (ms) of a request's dispatch: the harness's span around
each `optimize_chunks_batched` call (the enqueue of the flat solve)."""

from egobench.harness import readers


def read(run):
    return readers.span_ms(run, "dispatch")
