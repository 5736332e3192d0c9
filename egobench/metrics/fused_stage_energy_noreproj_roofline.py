"""Kernel 2 (csrc/fused_energy.cu, the stage-2 energy): per cent of its
least time at the run's shapes in its mean time a launch in the device
trace."""

from egobench.harness import readers


def read(run):
    return readers.energy_roofline(run, "fused_energy_kernel<false",
                                   "stage2", False)
