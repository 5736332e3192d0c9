"""Megabytes a request sends to the card while it is staged: the
program's counter `stage.h2d_bytes` (every `SequenceOptimizer._put`)
summed under the request's id, over the requests staged inside the
window."""

from egobench.harness import program_spans


def read(run):
    b = program_spans.per_request(run, "stage.h2d_bytes", "stage")
    return None if b is None else b / 1e6
