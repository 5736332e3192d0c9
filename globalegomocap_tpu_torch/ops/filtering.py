"""Gaussian sequence smoothing with scipy.ndimage.gaussian_filter1d's
default semantics (truncate 4, 'reflect' boundary), and the one-euro
filter.

Counterpart of `globalegomocap_tpu/ops/filtering.py`.  The serve path
folds the smoothing into the merge matrix (optimize/window.py), which
builds its block from `_gaussian_kernel`.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F


def _gaussian_kernel(sigma: float, truncate: float = 4.0) -> np.ndarray:
    """The normalised discrete Gaussian scipy uses, radius
    int(truncate * sigma + 0.5)."""
    radius = int(truncate * float(sigma) + 0.5)
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    w = np.exp(-0.5 / (float(sigma) ** 2) * x ** 2)
    return (w / w.sum()).astype(np.float32)


def gaussian_filter1d(seq: torch.Tensor, sigma: float, dim: int = 0,
                      truncate: float = 4.0) -> torch.Tensor:
    """Gaussian-smooth `seq` along `dim` ('reflect' = edge sample
    duplicated, numpy's 'symmetric' padding)."""
    kernel = torch.as_tensor(_gaussian_kernel(sigma, truncate),
                             device=seq.device, dtype=seq.dtype)
    radius = (kernel.shape[0] - 1) // 2
    moved = seq.movedim(dim, -1)
    flat = moved.reshape(-1, 1, moved.shape[-1])
    t = flat.shape[-1]
    # symmetric padding of width radius (radius < t assumed, as scipy's
    # reflect mode repeats beyond that)
    idx = torch.arange(-radius, t + radius, device=seq.device)
    idx = torch.where(idx < 0, -idx - 1, idx)
    idx = torch.where(idx >= t, 2 * t - idx - 1, idx)
    padded = flat.index_select(-1, idx)
    out = F.conv1d(padded, kernel.view(1, 1, -1))
    return out.reshape(moved.shape).movedim(-1, dim)


def _smoothing_factor(t_e, cutoff):
    r = 2.0 * math.pi * cutoff * t_e
    return r / (r + 1.0)


def one_euro_filter(timestamps: torch.Tensor, values: torch.Tensor,
                    min_cutoff: float = 1.0, beta: float = 0.0,
                    d_cutoff: float = 1.0) -> torch.Tensor:
    """The one-euro filter over a whole sequence: timestamps (T,), values
    (T, ...) -> the filtered (T, ...), the first sample kept (the
    reference's scalar OneEuroFilter recurrence, over every trailing axis
    at once; the JAX package runs it as a lax.scan)."""
    x_prev = values[0]
    dx_prev = torch.zeros_like(x_prev)
    out = [x_prev]
    for i in range(1, values.shape[0]):
        t_e = timestamps[i] - timestamps[i - 1]
        a_d = _smoothing_factor(t_e, d_cutoff)
        dx_hat = a_d * ((values[i] - x_prev) / t_e) + (1.0 - a_d) * dx_prev
        a = _smoothing_factor(t_e, min_cutoff + beta * dx_hat.abs())
        x_prev = a * values[i] + (1.0 - a) * x_prev
        dx_prev = dx_hat
        out.append(x_prev)
    return torch.stack(out)
