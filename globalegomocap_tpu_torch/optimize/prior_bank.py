"""Prior-regime matching: the motion statistic and the bank of priors.

Counterpart of `globalegomocap_tpu/optimize/prior_bank.py`.  A VAE prior
is a motion model, and one trained on slow smooth motion hurts on jerky
input.  `motion_accel_stat` measures a pose sequence's regime (the rms
acceleration in the human-motion band, noise floor removed); the trainer
writes it into each checkpoint's sidecar as `motion_stats["accel_mean"]`.
A `PriorBank` holds named (local, global) prior pairs, each tagged with
that statistic of its training windows, and `select` returns the entry
nearest a batch's statistic in log space.  `SequenceOptimizer(...,
prior_bank=...)` measures each staged batch and solves it with the
selected pair.

One torch body computes the statistic: `motion_accel_stat` takes a
host array and measures it on the CPU (host staging, the trainer);
`motion_accel_stat_torch` measures a tensor where it lies (device
staging measures the staged stack on the card and reads back one
scalar).  An entry holds the two priors' port state dicts where the JAX
package's holds Flax variables.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

FPS = 25.0           # the corpus frame rate (reference: frame_rate=25)
BAND = (0.2, 3.0)    # human-motion band (Hz)
NOISE_LO = 8.0       # flat-noise estimation band starts here (Hz)
NOISE_FACTOR = 3.0   # subtract this multiple of the noise floor


def _spec_accel(pose: torch.Tensor, fps, lo, hi, noise_lo, nfac):
    """The spectral statistic of float32 (..., F, J, 3) poses, any
    device: a 0-d tensor on pose's device."""
    n = pose.shape[-3]
    x = pose.movedim(-3, -1)                        # (..., J, 3, F)
    x = x - x.mean(dim=-1, keepdim=True)
    psd = torch.fft.rfft(x, dim=-1).abs() ** 2 / n ** 2 * 2
    f = np.fft.rfftfreq(n, d=1.0 / fps)
    idx = lambda mask: torch.from_numpy(  # noqa: E731
        np.flatnonzero(mask)).to(pose.device)
    nb = f >= noise_lo
    if nb.any():
        noise = psd[..., idx(nb)].mean(dim=-1, keepdim=True)
        psd = torch.clamp(psd - nfac * noise, min=0)
    band = (f >= lo) & (f <= hi)
    w = ((2 * np.pi * f / fps) ** 4)[band]          # |accel|^2 weight
    acc2 = (psd[..., idx(band)]
            * torch.as_tensor(w, dtype=psd.dtype, device=pose.device)
            ).sum(dim=-1)                           # per (J, coord)
    return torch.sqrt(acc2.sum(dim=-1).mean())


def motion_accel_stat(pose, window: int | None = None,
                      fps: float = FPS) -> float:
    """Rms acceleration (m/frame^2) of (..., F, J, 3) poses in the
    0.2-3 Hz band, with the white-noise floor measured above 8 Hz
    subtracted before the omega^4 weighting, as a host float; computed
    on the host's CPU.  window: split the frame axis into segments of
    this length first (a prior's seq_len), None = the whole sequence."""
    return float(motion_accel_stat_torch(
        torch.from_numpy(np.array(pose, dtype=np.float32)), window, fps))


def motion_accel_stat_torch(pose: torch.Tensor, window: int | None = None,
                            fps: float = FPS) -> torch.Tensor:
    """`motion_accel_stat` of a (..., F, J, 3) tensor, computed where the
    tensor lies (`torch.fft.rfft` in float32): a 0-d tensor, so that the
    caller reads back one scalar, not the stack (the JAX package's
    `motion_accel_stat_jax`)."""
    p = pose.to(torch.float32)
    if window and p.shape[-3] >= window:
        m = p.shape[-3] // window
        p = p[..., :m * window, :, :].reshape(
            p.shape[:-3] + (m, window) + p.shape[-2:])
    return _spec_accel(p, fps, BAND[0], BAND[1], NOISE_LO, NOISE_FACTOR)


def windows_accel_stat(windows: np.ndarray) -> float:
    """`motion_accel_stat` of training windows (N, T, J*3), the
    AmassWindows layout; nan for an empty set."""
    w = np.asarray(windows, dtype=np.float32)
    if w.size == 0:
        return float("nan")
    n, t = w.shape[0], w.shape[1]
    return motion_accel_stat(w.reshape(n, t, -1, 3))


class PriorEntry(NamedTuple):
    name: str
    local_variables: dict   # the local prior's state dict
    global_variables: dict  # the global prior's
    accel_mean: float


class PriorBank:
    """Named prior pairs tagged with their training motion's statistic.
    Selection is nearest-neighbour in log(accel_mean): acceleration
    scales multiplicatively between regimes (twice the amplitude at twice
    the frequency is 8x the acceleration), so ratios, not differences,
    are the distance."""

    def __init__(self, entries: "list[PriorEntry] | None" = None):
        self.entries: list[PriorEntry] = list(entries or [])

    def add(self, name: str, local_variables, global_variables,
            accel_mean: float) -> "PriorBank":
        if accel_mean <= 0:
            raise ValueError(f"accel_mean must be positive, got "
                             f"{accel_mean} for prior '{name}'")
        self.entries.append(PriorEntry(name, local_variables,
                                       global_variables, float(accel_mean)))
        return self

    def select(self, accel_mean: float) -> PriorEntry:
        """The entry nearest `accel_mean` in log space (the first of
        equals)."""
        return self.entries[nearest_index(
            [e.accel_mean for e in self.entries], accel_mean)]


def nearest_index(accel_means: list, accel_mean: float) -> int:
    """The index of the statistic in `accel_means` nearest `accel_mean`
    in log space (the first of equals): `PriorBank.select`'s rule."""
    if not accel_means:
        raise ValueError("PriorBank is empty")
    target = math.log(max(float(accel_mean), 1e-12))
    return min(range(len(accel_means)), key=lambda i: abs(
        math.log(accel_means[i]) - target))
