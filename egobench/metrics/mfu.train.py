"""The train step's share (per cent) of the card's float32 peak (TF32
off, as the configuration states): the step's products
(counts/flops.py) over the mean step time of the window."""

from egobench.counts import flops


def read(run):
    f = run.facts
    return 100.0 * f["flops_per_step"] / (
        f["step_s"] * flops.PEAKS["f32_flop_per_s"])
