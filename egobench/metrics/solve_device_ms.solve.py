"""The card's time (ms) a request's solve takes on its stream: the
program's device span `runtime.device`, two CUDA events around each
submission's work, read when it retires."""

from egobench.harness import program_spans


def read(run):
    s = program_spans.per_request(run, "runtime.device")
    return None if s is None else 1e3 * s
