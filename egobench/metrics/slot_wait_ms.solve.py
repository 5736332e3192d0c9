"""Host time (ms) a request's submission waits for a free in-flight
slot: the program's `runtime.slot_wait` span in
`StreamingOptimizer._dispatch`."""

from egobench.harness import program_spans


def read(run):
    s = program_spans.per_request(run, "runtime.slot_wait")
    return None if s is None else 1e3 * s
