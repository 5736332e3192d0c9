"""Host time (ms) of a train step's `train.optimizer` span in the
program (inside `train.step`): Adam's `optimizer.step()`."""

from egobench.harness import program_spans


def read(run):
    s = program_spans.per_request(run, "train.optimizer", "train.step")
    return None if s is None else 1e3 * s
