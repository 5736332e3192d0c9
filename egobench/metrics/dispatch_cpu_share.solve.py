"""Per cent of the wall time of the program's `dispatch` spans (the
enqueue of each flat solve, `optimize_chunks_batched`) that the
dispatching thread spent on the CPU; the rest it waited (the GIL, a
blocking CUDA call, the scheduler)."""

from egobench.harness import program_spans


def read(run):
    return program_spans.cpu_share(run, "dispatch")
