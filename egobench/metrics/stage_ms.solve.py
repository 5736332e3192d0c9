"""Mean host time (ms) of a request's staging: the harness's span around
each `SequenceOptimizer.stage` call on the prefetcher's worker."""

from egobench.harness import readers


def read(run):
    return readers.span_ms(run, "stage")
