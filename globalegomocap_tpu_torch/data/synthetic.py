"""Synthetic test chunks in numpy: local motion, SLAM trajectory, fisheye
heatmaps and world ground truth that agree by construction.

Counterpart of `synthetic_chunk` in `globalegomocap_tpu/data/synthetic.py`
(same generators and seeds; the heatmap projection runs in float32 numpy
instead of jnp, so maps agree with the JAX fixture to float32 rounding).
"""

from __future__ import annotations

import numpy as np

from globalegomocap_tpu_torch.data.test_data import TestChunk
from globalegomocap_tpu_torch.ops.fisheye import EGOSYN_CALIBRATION
from globalegomocap_tpu_torch.ops.skeleton import MEAN3D_MM


def _rotz(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])


def synthetic_motion(n_frames: int, seed: int = 0,
                     motion_scale: float = 0.05,
                     freq_range: tuple = (0.3, 1.2)) -> np.ndarray:
    """(N, 15, 3) smooth local motion around the mean skeleton (metres):
    per-joint sinusoids plus a slow sway, at 25 fps."""
    rng = np.random.default_rng(seed)
    base = (MEAN3D_MM.T / 1000.0).astype(np.float64)
    t = np.arange(n_frames)[:, None, None] / 25.0
    freq = rng.uniform(*freq_range, size=(1, 15, 3))
    phase = rng.uniform(0, 2 * np.pi, size=(1, 15, 3))
    amp = rng.uniform(0.2, 1.0, size=(1, 15, 3)) * motion_scale
    wobble = amp * np.sin(2 * np.pi * freq * t + phase)
    sway = 0.01 * np.sin(2 * np.pi * 0.25 * t[:, :, :1])
    return base[None] + wobble + sway


def synthetic_camera_trajectory(n_frames: int, seed: int = 0) -> np.ndarray:
    """(N, 4, 4) smooth cam->world trajectory: a walking arc, slow yaw."""
    rng = np.random.default_rng(seed + 1)
    t = np.arange(n_frames) / 25.0
    speed = rng.uniform(0.5, 1.0)
    radius = rng.uniform(3.0, 6.0)
    ang = speed * t / radius
    pos = np.stack([radius * np.sin(ang),
                    radius * (1 - np.cos(ang)),
                    1.6 + 0.03 * np.sin(2 * np.pi * 1.4 * t)], axis=1)
    mats = np.tile(np.eye(4), (n_frames, 1, 1))
    for i in range(n_frames):
        mats[i, :3, :3] = _rotz(ang[i] + 0.05 * np.sin(2 * np.pi * 0.3 * t[i]))
        mats[i, :3, 3] = pos[i]
    return mats


def _world2camera_np(points: np.ndarray, calib: dict) -> np.ndarray:
    """float32 fisheye projection (..., 3) -> (..., 2) pixels."""
    p = points.astype(np.float32)
    poly = np.asarray(calib["polynomialW2C"], np.float32)
    cx = np.float32(calib["intrinsic"][0][2])
    cy = np.float32(calib["intrinsic"][1][2])
    x, y, z = p[..., 0], p[..., 1], -p[..., 2]
    norm = np.maximum(np.sqrt(x * x + y * y), np.float32(1e-9))
    theta = np.arctan(z / norm)
    rho = np.zeros_like(theta)
    for c in poly[::-1]:
        rho = rho * theta + c
    inv = rho / norm
    return np.stack([x * inv + cx, y * inv + cy], axis=-1)


def render_heatmaps(local_pose: np.ndarray, size: int = 64,
                    sigma_px: float = 1.5) -> np.ndarray:
    """Per-joint Gaussian heatmaps (N, H, W, J) on the 64x64 grid of the
    1024x1024 fisheye centre crop (x - 128, /16 downscale)."""
    n, j = local_pose.shape[0], local_pose.shape[1]
    p2d = _world2camera_np(local_pose.reshape(-1, 3), EGOSYN_CALIBRATION)
    hx = (p2d[:, 0] - 128.0) / 16.0
    hy = p2d[:, 1] / 16.0
    grid = np.arange(size)
    d2 = ((grid[None, None, :] - hx[:, None, None]) ** 2
          + (grid[None, :, None] - hy[:, None, None]) ** 2)
    maps = np.exp(-d2 / (2 * sigma_px ** 2)).astype(np.float32)
    return maps.reshape(n, j, size, size).transpose(0, 2, 3, 1)


def synthetic_chunk(n_frames: int = 100, seed: int = 0,
                    noise_std: float = 0.03, motion_scale: float = 0.05,
                    freq_range: tuple = (0.3, 1.2)) -> TestChunk:
    """One chunk in the test_data.pkl contract: the estimate is the true
    local pose plus white noise, the heatmaps peak at the true
    projections, the cameras are exact.  motion_scale / freq_range pass
    to `synthetic_motion` (the jerky regime of the JAX package's v2
    corpus: 0.10 / (0.5, 2.5))."""
    rng = np.random.default_rng(seed + 2)
    local_true = synthetic_motion(n_frames, seed, motion_scale=motion_scale,
                                  freq_range=freq_range)
    cams = synthetic_camera_trajectory(n_frames, seed)
    homo = np.concatenate([local_true, np.ones((n_frames, 15, 1))], axis=2)
    gt_global = np.einsum("nij,nkj->nki", cams, homo)[:, :, :3]
    noise = rng.normal(scale=noise_std, size=local_true.shape)
    est_local = (local_true + noise).astype(np.float32)
    est_global = np.einsum(
        "nij,nkj->nki", cams,
        np.concatenate([est_local, np.ones((n_frames, 15, 1))], axis=2)
    )[:, :, :3]
    return TestChunk(
        estimated_local=est_local,
        estimated_global=est_global.astype(np.float32),
        gt_global=gt_global.astype(np.float32),
        camera_poses=cams.astype(np.float32),
        heatmaps=render_heatmaps(local_true),
    )


def synthetic_amass(n_sequences: int = 12, frames_per_seq: int = 300,
                    frame_rate: int = 25, seed: int = 0,
                    motion_scale: float = 0.08,
                    freq_range: tuple = (0.3, 1.2),
                    motion_fn=None) -> list[dict]:
    """Synthetic AMASS-style training pkls: dicts with `local_pose_list`
    (N, 15, 3) float32, `cam_list` ({'loc', 'rot'} a frame, the rotation
    as a scipy xyzw quaternion) and `frame_rate` (reference contract:
    networks/dataset/global_dataset.py:88-100).  Counterpart of the JAX
    package's `synthetic_amass`, same generators and seeds.
    motion_fn: (n_frames, seed) -> (N, 15, 3) replaces the sinusoidal
    generator."""
    from scipy.spatial.transform import Rotation

    out = []
    for s in range(n_sequences):
        local = (motion_fn(frames_per_seq, seed + 10 * s)
                 if motion_fn is not None else
                 synthetic_motion(frames_per_seq, seed + 10 * s,
                                  motion_scale=motion_scale,
                                  freq_range=freq_range))
        cams = synthetic_camera_trajectory(frames_per_seq, seed + 10 * s)
        cam_list = [{"loc": cams[i, :3, 3],
                     "rot": Rotation.from_matrix(cams[i, :3, :3]).as_quat()}
                    for i in range(frames_per_seq)]
        out.append({"local_pose_list": local.astype(np.float32),
                    "cam_list": cam_list, "frame_rate": frame_rate})
    return out
