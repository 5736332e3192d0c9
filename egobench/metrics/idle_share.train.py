"""Per cent of the traced part of a train window with no operation on the
device (torch.profiler: kernels, copies and sets)."""

from egobench.harness import readers


def read(run):
    return readers.idle_share(run)
