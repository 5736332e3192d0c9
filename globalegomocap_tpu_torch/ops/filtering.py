"""Gaussian sequence smoothing with scipy.ndimage.gaussian_filter1d's
default semantics (truncate 4, 'reflect' boundary).

Counterpart of `globalegomocap_tpu/ops/filtering.py`.  The serve path
folds the smoothing into the merge matrix (optimize/window.py), which
builds its block from `_gaussian_kernel`.
"""

from __future__ import annotations

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
