"""Mean host time (ms) of a train step's dispatch: the harness's span
around each call of the trainer's step."""

from egobench.harness import readers


def read(run):
    return readers.span_ms(run, "step")
