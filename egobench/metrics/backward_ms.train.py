"""Host time (ms) of a train step's `train.backward` span in the program
(inside `train.step`): `zero_grad` and `backward`, with the all-reduce
of a mesh of several ranks."""

from egobench.harness import program_spans


def read(run):
    s = program_spans.per_request(run, "train.backward", "train.step")
    return None if s is None else 1e3 * s
