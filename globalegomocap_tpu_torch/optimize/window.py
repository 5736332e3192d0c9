"""Sliding windows and the overlap merge as one matrix.

Counterpart of `globalegomocap_tpu/optimize/window.py`: 10-frame windows
at stride 8 (overlap 2); the merge averages overlapping frames as one
matrix that, when asked, folds in the final Gaussian time-smoothing
(`merge_windows_matmul`), or as a scatter-mean (`merge_windows`, the
configuration's matmul_merge=False).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from globalegomocap_tpu_torch.ops.filtering import _gaussian_kernel


def num_windows(n_frames: int, seq_len: int = 10, stride: int = 8) -> int:
    """Windows of range(0, n - seq_len + 1, stride)."""
    if n_frames < seq_len:
        return 0
    return (n_frames - seq_len) // stride + 1


def window_indices(n_frames: int, seq_len: int = 10,
                   stride: int = 8) -> np.ndarray:
    """(W, T) frame-index table of the windows."""
    w = num_windows(n_frames, seq_len, stride)
    return (np.arange(w) * stride)[:, None] + np.arange(seq_len)[None, :]


def slice_windows(seq: torch.Tensor, seq_len: int = 10, stride: int = 8,
                  dim: int = 0) -> torch.Tensor:
    """Frame axis `dim` of length N -> (..., W, T, ...) windows."""
    n = seq.shape[dim]
    idx = _window_index_on(n, seq_len, stride, seq.device)
    out = seq.index_select(dim, idx)
    return out.reshape(seq.shape[:dim] + (num_windows(n, seq_len, stride),
                                          seq_len) + seq.shape[dim + 1:])


@functools.lru_cache(maxsize=64)
def _window_index_on(n: int, seq_len: int, stride: int,
                     device: torch.device) -> torch.Tensor:
    """`window_indices` flattened, on `device`, copied there at the first
    call only: a solve on the card then issues no host-to-device copy,
    which would wait for the work already queued.  Read-only."""
    return torch.as_tensor(window_indices(n, seq_len, stride).reshape(-1),
                           device=device)


@functools.lru_cache(maxsize=64)
def _merge_matrix_on(w: int, t: int, stride: int, smooth_sigma: float,
                     device: torch.device) -> torch.Tensor:
    """`merge_matrix` on `device`, copied there at the first call only.
    Read-only."""
    return torch.as_tensor(merge_matrix(w, t, stride, smooth_sigma),
                           device=device)


@functools.lru_cache(maxsize=None)
def merge_matrix(w: int, t: int, stride: int = 8,
                 smooth_sigma: float = 0.0) -> np.ndarray:
    """The (covered_frames, W*T) matrix M with merged = M @ flat(windows):
    a scatter-mean of the overlapping frames, times the Gaussian
    smoothing matrix when smooth_sigma > 0 (both are linear maps along
    time, so S @ (M @ x) = (S @ M) @ x).  Callers must not mutate the
    cached array."""
    n = (w - 1) * stride + t
    idx = window_indices(n, t, stride).reshape(-1)
    m = np.zeros((n, w * t), np.float32)
    m[idx, np.arange(w * t)] = 1.0
    m /= m.sum(axis=1, keepdims=True)
    if smooth_sigma > 0.0:
        # the smoothing filter applied to the identity, same kernel and
        # 'symmetric' padding as gaussian_filter1d
        k = _gaussian_kernel(smooth_sigma, 4.0)
        r = (len(k) - 1) // 2
        padded = np.pad(np.eye(n, dtype=np.float32), [(r, r), (0, 0)],
                        mode="symmetric")
        s = np.zeros((n, n), np.float32)
        for i in range(len(k)):
            s += k[i] * padded[i:i + n]
        m = s @ m
    return m


def merge_windows_matmul(windows: torch.Tensor, stride: int = 8,
                         smooth_sigma: float = 0.0,
                         batch_dims: int = 0) -> torch.Tensor:
    """(*batch, W, T, *feat) windows -> (*batch, covered, *feat) as one
    (batched) matmul against `merge_matrix`; `batch_dims` leading axes
    (the chunk axis of the flat path) are batched over."""
    lead = windows.shape[:batch_dims]
    w, t = windows.shape[batch_dims], windows.shape[batch_dims + 1]
    feat = windows.shape[batch_dims + 2:]
    m = _merge_matrix_on(w, t, stride, float(smooth_sigma), windows.device)
    flat = windows.reshape(lead + (w * t, -1)).to(torch.float32)
    out = torch.matmul(m, flat)
    return out.reshape(lead + (m.shape[0],) + feat).to(windows.dtype)


def merge_windows(windows: torch.Tensor, stride: int = 8,
                  batch_dims: int = 0) -> torch.Tensor:
    """(*batch, W, T, *feat) windows -> (*batch, covered, *feat): the
    overlapping frames averaged by a scatter-add of every window frame
    and a division by each frame's count (the reference's merge)."""
    lead = windows.shape[:batch_dims]
    w, t = windows.shape[batch_dims], windows.shape[batch_dims + 1]
    feat = windows.shape[batch_dims + 2:]
    n = (w - 1) * stride + t
    idx = _window_index_on(n, t, stride, windows.device)
    flat = windows.reshape(lead + (w * t,) + feat)
    acc = flat.new_zeros(lead + (n,) + feat).index_add_(batch_dims, idx,
                                                        flat)
    cnt = flat.new_zeros((n,)).index_add_(0, idx, flat.new_ones((w * t,)))
    return acc / cnt.reshape((n,) + (1,) * len(feat))
