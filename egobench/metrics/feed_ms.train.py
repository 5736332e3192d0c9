"""Host time (ms) a train step's batch takes to reach the step: the
program's `data.batch` (the gather in `AmassWindows.epoch_batches`) and
`train.batch` (`Trainer._device_batch`, the copy) spans in the window,
over the steps there."""

from egobench.harness import program_spans


def read(run):
    s = program_spans.window_per_request(run, ("data.batch", "train.batch"),
                                         "train.step")
    return None if s is None else 1e3 * s
