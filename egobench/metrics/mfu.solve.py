"""The whole solve's share (per cent) of the card's dense bf16 peak: the
model operations a window (counts/flops.py, at the run's tier) times
the windows solved a second."""

from egobench.counts import flops


def read(run):
    f = run.facts
    return 100.0 * f["windows_per_s"] * f["flops_per_window"] \
        / flops.PEAKS["bf16_flop_per_s"]
