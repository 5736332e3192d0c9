"""The motion-regime statistic that the trainer records with a prior.

Counterpart of `_spec_accel`, `motion_accel_stat` and
`windows_accel_stat` in `globalegomocap_tpu/optimize/prior_bank.py`, in
numpy: the rms acceleration of poses in the human-motion band, which the
trainer writes into each checkpoint's sidecar as
`motion_stats["accel_mean"]`.  `PriorBank` and the driver's selection
among priors are not ported yet (ROADMAP §A item 2).
"""

from __future__ import annotations

import numpy as np

FPS = 25.0           # the corpus frame rate (reference: frame_rate=25)
BAND = (0.2, 3.0)    # human-motion band (Hz)
NOISE_LO = 8.0       # flat-noise estimation band starts here (Hz)
NOISE_FACTOR = 3.0   # subtract this multiple of the noise floor


def _spec_accel(xp, pose, fps, lo, hi, noise_lo, nfac):
    """The spectral statistic of (..., F, J, 3) poses as a 0-d value
    (xp is numpy; the JAX package shares this body with jax.numpy)."""
    n = pose.shape[-3]
    x = xp.moveaxis(pose, -3, -1)                   # (..., J, 3, F)
    x = x - x.mean(axis=-1, keepdims=True)
    psd = (xp.abs(xp.fft.rfft(x, axis=-1)) ** 2) / n ** 2 * 2
    f = np.fft.rfftfreq(n, d=1.0 / fps)
    nb = f >= noise_lo
    if nb.any():
        noise = psd[..., nb].mean(axis=-1, keepdims=True)
        psd = xp.clip(psd - nfac * noise, 0, None)
    band = (f >= lo) & (f <= hi)
    w = (2 * np.pi * f / fps) ** 4                  # |accel|^2 weight
    acc2 = (psd[..., band] * w[band]).sum(axis=-1)  # per (J, coord)
    return xp.sqrt(acc2.sum(axis=-1).mean())


def motion_accel_stat(pose, window: int | None = None,
                      fps: float = FPS) -> float:
    """Rms acceleration (m/frame^2) of (..., F, J, 3) poses in the
    0.2-3 Hz band, with the white-noise floor measured above 8 Hz
    subtracted before the omega^4 weighting.  window: split the frame
    axis into segments of this length first (a prior's seq_len), None =
    the whole sequence."""
    p = np.asarray(pose, dtype=np.float32)
    if window and p.shape[-3] >= window:
        m = p.shape[-3] // window
        p = p[..., :m * window, :, :].reshape(
            p.shape[:-3] + (m, window) + p.shape[-2:])
    return float(_spec_accel(np, p, fps, BAND[0], BAND[1], NOISE_LO,
                             NOISE_FACTOR))


def windows_accel_stat(windows: np.ndarray) -> float:
    """`motion_accel_stat` of training windows (N, T, J*3), the
    AmassWindows layout; nan for an empty set."""
    w = np.asarray(windows, dtype=np.float32)
    if w.size == 0:
        return float("nan")
    n, t = w.shape[0], w.shape[1]
    return motion_accel_stat(w.reshape(n, t, -1, 3))
