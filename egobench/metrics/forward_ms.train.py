"""Host time (ms) of a train step's `train.forward` span in the program
(inside `train.step`): the learning rate, the encode, the noise, the
decode and the loss."""

from egobench.harness import program_spans


def read(run):
    s = program_spans.per_request(run, "train.forward", "train.step")
    return None if s is None else 1e3 * s
