"""Kernel 1 (csrc/fused_energy.cu, the stage-1 energy with the
reprojection): per cent of its least time at the run's shapes in its
mean time a launch in the device trace."""

from egobench.harness import readers


def read(run):
    return readers.energy_roofline(run, "fused_energy_kernel<true",
                                   "stage1", True)
