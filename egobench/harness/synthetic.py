"""Synthetic captures and training motion, numpy only.

Frozen copies of the generators of
`globalegomocap_tpu_torch/data/synthetic.py` (as of the benchmark's
first version): `synthetic_motion` (:39), `synthetic_motion_contacts`
(:56), `dropout_heatmaps` (:82), `synthetic_camera_trajectory` (:109),
`perturb_camera_trajectory` (:125), `_world2camera_np` (:155),
`render_heatmaps` (:173), `degrade_heatmaps` (:189) and
`synthetic_chunk` (:213), with the same draws in the same order, so a
chunk made here from a seed is the chunk the program's generator makes
from it.  `training_windows` stands for `synthetic_amass` (:263) followed
by `data/amass.py::window_sequences` (:66) at local_pose=False: the same
motion and camera draws, windowed straight from the camera matrices
(the program's route through scipy quaternions and back is left out).
The benchmark calls only these copies, never the program's generators.
"""

from __future__ import annotations

import numpy as np

# the mean reference skeleton in millimetres, joints as columns (3, 15)
# (globalegomocap_tpu_torch/ops/skeleton.py:34)
MEAN3D_MM = np.array([
    [6.12454847, 145.97761, 258.72083056, 281.27554815, -130.58758154,
     -217.63663461, -234.47818229, 122.57391072, 157.99031993, 172.09879492,
     215.33356937, -52.15750419, -59.0959752, -36.18717374, -80.10264932],
    [233.90813433, 232.60823975, 188.18493809, 72.79136312, 239.16565076,
     203.68825151, 91.05888921, 239.95855861, 133.01398165, 176.20098748,
     37.42165039, 243.04617535, 149.38252591, 180.44482382, 44.79721165],
    [176.25176082, 220.73112637, 404.39836013, 488.37987609, 232.02432922,
     436.14841643, 529.22255096, 675.05067301, 1019.17833662, 1331.949378,
     1391.75072893, 683.67509016, 1037.58363271, 1353.00767289,
     1407.87463384],
])
J = 15


def _rotz(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])


def synthetic_motion(n_frames, seed, motion_scale=0.05,
                     freq_range=(0.3, 1.2)):
    """(N, 15, 3) smooth local motion around the mean skeleton (metres)."""
    rng = np.random.default_rng(seed)
    base = (MEAN3D_MM.T / 1000.0).astype(np.float64)
    t = np.arange(n_frames)[:, None, None] / 25.0
    freq = rng.uniform(*freq_range, size=(1, 15, 3))
    phase = rng.uniform(0, 2 * np.pi, size=(1, 15, 3))
    amp = rng.uniform(0.2, 1.0, size=(1, 15, 3)) * motion_scale
    wobble = amp * np.sin(2 * np.pi * freq * t + phase)
    sway = 0.01 * np.sin(2 * np.pi * 0.25 * t[:, :, :1])
    return base[None] + wobble + sway


def synthetic_motion_contacts(n_frames, seed, motion_scale=0.06,
                              step_period=10, impact_scale=0.035,
                              decay=4.0):
    """Motion with footstrike contacts: a depth bob whose velocity flips at
    each contact and a decaying per-joint kick from each contact on."""
    rng = np.random.default_rng(seed + 13)
    out = synthetic_motion(n_frames, seed, motion_scale=motion_scale)
    t = np.arange(n_frames)
    phase = (t % step_period) / step_period
    bob = impact_scale * (1.0 - 2.0 * np.abs(phase - 0.5))
    out[:, :, 2] += bob[:, None]
    contacts = np.nonzero(np.diff(phase) < 0)[0] + 1
    for c in contacts:
        kick = rng.normal(scale=impact_scale, size=(15, 3))
        env = np.exp(-decay * np.arange(n_frames - c) / step_period)
        out[c:] += kick[None] * env[:, None, None]
    return out


def dropout_heatmaps(maps, seed, rate=0.2, min_run=5, max_run=20,
                     floor=0.01):
    """Occlusion dropout: runs of frames whose map is the constant floor."""
    rng = np.random.default_rng(seed + 17)
    n, h, w, j = maps.shape
    out = maps.copy()
    mean_run = 0.5 * (min_run + max_run)
    p_start = min(1.0, rate / mean_run)
    for k in range(j):
        i = 0
        while i < n:
            if rng.random() < p_start:
                run = int(rng.integers(min_run, max_run + 1))
                out[i:i + run, :, :, k] = floor
                i += run
            else:
                i += 1
    return out.astype(np.float32)


def synthetic_camera_trajectory(n_frames, seed):
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


def perturb_camera_trajectory(cams, seed, drift_rot=0.03, drift_trans=0.05,
                              jitter_rot=0.008, jitter_trans=0.008):
    """SLAM-like drift and jitter on (N, 4, 4) cam->world matrices."""
    rng = np.random.default_rng(seed + 7)
    n = len(cams)

    def walk(scale, shape):
        return np.cumsum(rng.normal(scale=scale / np.sqrt(max(n, 1)),
                                    size=shape), axis=0)

    yaw = walk(drift_rot, n) + rng.normal(scale=jitter_rot, size=n)
    tilt = walk(drift_rot / 2, n) + rng.normal(scale=jitter_rot, size=n)
    dt = walk(drift_trans, (n, 3)) + rng.normal(scale=jitter_trans,
                                                size=(n, 3))
    out = cams.copy()
    for i in range(n):
        cx, sx = np.cos(tilt[i]), np.sin(tilt[i])
        rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
        err = _rotz(yaw[i]) @ rx
        out[i, :3, :3] = err @ cams[i, :3, :3]
        out[i, :3, 3] = cams[i, :3, 3] + dt[i]
    return out


def world2camera_np(points, camera):
    """float32 fisheye projection (..., 3) -> (..., 2) pixels; `camera` is
    a configuration's calibration ({'intrinsic', 'polynomialW2C', ...})."""
    p = points.astype(np.float32)
    poly = np.asarray(camera["polynomialW2C"], dtype=np.float32)
    cx = np.float32(camera["intrinsic"][0][2])
    cy = np.float32(camera["intrinsic"][1][2])
    x, y, z = p[..., 0], p[..., 1], -p[..., 2]
    norm = np.maximum(np.sqrt(x * x + y * y), np.float32(1e-9))
    theta = np.arctan(z / norm)
    rho = np.zeros_like(theta)
    for c in poly[::-1]:
        rho = rho * theta + c
    inv = rho / norm
    return np.stack([x * inv + cx, y * inv + cy], axis=-1)


def render_heatmaps(local_pose, camera, size=64, sigma_px=1.5):
    """Per-joint Gaussian heatmaps (N, H, W, J) on the 64x64 grid of the
    1024x1024 fisheye centre crop (x - 128, /16 downscale)."""
    n, j = local_pose.shape[0], local_pose.shape[1]
    p2d = world2camera_np(local_pose.reshape(-1, 3), camera)
    hx = (p2d[:, 0] - 128.0) / 16.0
    hy = p2d[:, 1] / 16.0
    grid = np.arange(size)
    d2 = ((grid[None, None, :] - hx[:, None, None]) ** 2
          + (grid[None, :, None] - hy[:, None, None]) ** 2)
    maps = np.exp(-d2 / (2 * sigma_px ** 2)).astype(np.float32)
    return maps.reshape(n, j, size, size).transpose(0, 2, 3, 1)


def degrade_heatmaps(maps, seed, occlusion_prob=0.15, distractor_prob=0.15,
                     distractor_sigma=2.5, floor=0.02):
    """Occlusion flattening, distractor peaks and a floor on (N, H, W, J)."""
    rng = np.random.default_rng(seed + 3)
    n, h, w, j = maps.shape
    out = maps.copy()
    occl = rng.random((n, j)) < occlusion_prob
    distract = rng.random((n, j)) < distractor_prob
    cx = rng.uniform(4, w - 4, size=(n, j))
    cy = rng.uniform(4, h - 4, size=(n, j))
    gy = np.arange(h)[:, None]
    gx = np.arange(w)[None, :]
    for i in range(n):
        for k in range(j):
            if occl[i, k]:
                out[i, :, :, k] = 0.05 * out[i, :, :, k] + floor
            if distract[i, k]:
                d2 = ((gx - cx[i, k]) ** 2 + (gy - cy[i, k]) ** 2)
                out[i, :, :, k] += 0.9 * np.exp(
                    -d2 / (2 * distractor_sigma ** 2))
    return (out + floor).astype(np.float32)


def synthetic_chunk(camera, n_frames=100, seed=0, noise_std=0.03,
                    cam_noise=None, degrade=None, motion_scale=0.05,
                    freq_range=(0.3, 1.2), contacts=None, dropout=None):
    """One chunk as a dict of the test_data.pkl fields: the estimate is
    the true local pose plus white noise, the maps peak at the true
    projections.  `contacts` (keyword arguments of
    `synthetic_motion_contacts`) replaces the sinusoidal motion,
    `dropout` (of `dropout_heatmaps`) follows `degrade`: the program's
    `motion=` and `heat_transform=` as `synthetic_chunk_v3` uses them."""
    rng = np.random.default_rng(seed + 2)
    if contacts is not None:
        local_true = synthetic_motion_contacts(n_frames, seed, **contacts)
    else:
        local_true = synthetic_motion(n_frames, seed,
                                      motion_scale=motion_scale,
                                      freq_range=tuple(freq_range))
    cams_true = synthetic_camera_trajectory(n_frames, seed)
    cams = (cams_true if cam_noise is None
            else perturb_camera_trajectory(cams_true, seed, **cam_noise))
    homo = np.concatenate([local_true, np.ones((n_frames, 15, 1))], axis=2)
    gt_global = np.einsum("nij,nkj->nki", cams_true, homo)[:, :, :3]
    noise = rng.normal(scale=noise_std, size=local_true.shape)
    est_local = (local_true + noise).astype(np.float32)
    est_global = np.einsum(
        "nij,nkj->nki", cams,
        np.concatenate([est_local, np.ones((n_frames, 15, 1))], axis=2)
    )[:, :, :3]
    heat = render_heatmaps(local_true, camera)
    if degrade is not None:
        heat = degrade_heatmaps(heat, seed, **degrade)
    if dropout is not None:
        heat = dropout_heatmaps(heat, seed, **dropout)
    return {"estimated_local": est_local,
            "estimated_global": est_global.astype(np.float32),
            "gt_global": gt_global.astype(np.float32),
            "camera_poses": cams.astype(np.float32),
            "heatmaps": heat}


def training_windows(n_sequences, frames_per_seq, seed, motion_scale=0.08,
                     freq_range=(0.3, 1.2), frame_num=10):
    """Relative-global training windows (W, frame_num, 45) float32 of
    `n_sequences` synthetic sequences: every slide window (stride 1, the
    last start n - frame_num - 1, as the reference's dataset slices), each
    pose moved into its window's first camera frame, inv(C_0) C_i p."""
    out = []
    for s in range(n_sequences):
        local = synthetic_motion(frames_per_seq, seed + 10 * s,
                                 motion_scale=motion_scale,
                                 freq_range=freq_range).astype(np.float32)
        cams = synthetic_camera_trajectory(frames_per_seq,
                                           seed + 10 * s).astype(np.float32)
        starts = np.arange(0, frames_per_seq - frame_num)
        idx = starts[:, None] + np.arange(frame_num)[None, :]
        pose = local[idx]                                 # (w, T, 15, 3)
        cam = cams[idx]                                   # (w, T, 4, 4)
        rot0 = cam[:, :1, :3, :3]
        rel_rot = np.swapaxes(rot0, -1, -2) @ cam[:, :, :3, :3]
        rel_t = (np.swapaxes(rot0, -1, -2)
                 @ (cam[:, :, :3, 3] - cam[:, :1, :3, 3])[..., None])[..., 0]
        rel = pose @ np.swapaxes(rel_rot, -1, -2) + rel_t[:, :, None, :]
        out.append(rel.reshape(len(starts), frame_num, 45))
    return np.concatenate(out).astype(np.float32)
