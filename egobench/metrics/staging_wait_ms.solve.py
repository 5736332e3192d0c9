"""Host time (ms) the dispatching thread waits for a request's staged
batch: the program's `prefetch.wait` span around the prefetcher's queue
(`StagePrefetcher.__iter__`)."""

from egobench.harness import program_spans


def read(run):
    s = program_spans.per_request(run, "prefetch.wait")
    return None if s is None else 1e3 * s
