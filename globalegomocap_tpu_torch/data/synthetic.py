"""Synthetic test chunks in numpy: local motion, SLAM trajectory, fisheye
heatmaps and world ground truth that agree by construction, and the two
robustness corpora built on them.

Counterpart of `globalegomocap_tpu/data/synthetic.py`, with the same
generators, seeds and order of draws: `synthetic_chunk` with its camera
noise (`perturb_camera_trajectory`), heatmap degradation
(`degrade_heatmaps`), precomputed motion and heatmap transform;
`synthetic_chunk_v2` (jerky motion, SLAM drift and jitter, occluded and
multimodal maps) and `synthetic_chunk_v3` (footstrike contacts,
`synthetic_motion_contacts`, and occlusion dropout, `dropout_heatmaps`).
Everything is numpy on both sides and equal bit for bit, except the
heatmaps: the JAX package projects the joints through jnp, the port in
float32 numpy (`_world2camera_np`), so the maps agree to float32
rounding.
"""

from __future__ import annotations

import numpy as np

from globalegomocap_tpu_torch.data.test_data import TestChunk
from globalegomocap_tpu_torch.ops import fisheye
from globalegomocap_tpu_torch.ops.skeleton import MEAN3D_MM


def _rotz(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])


def _base_local_pose() -> np.ndarray:
    """The mean skeleton in metres in the head-camera frame (15, 3)."""
    return (MEAN3D_MM.T / 1000.0).astype(np.float64)


def synthetic_motion(n_frames: int, seed: int = 0,
                     motion_scale: float = 0.05,
                     freq_range: tuple = (0.3, 1.2)) -> np.ndarray:
    """(N, 15, 3) smooth local motion around the mean skeleton (metres):
    per-joint sinusoids plus a slow sway, at 25 fps."""
    rng = np.random.default_rng(seed)
    base = _base_local_pose()
    t = np.arange(n_frames)[:, None, None] / 25.0
    freq = rng.uniform(*freq_range, size=(1, 15, 3))
    phase = rng.uniform(0, 2 * np.pi, size=(1, 15, 3))
    amp = rng.uniform(0.2, 1.0, size=(1, 15, 3)) * motion_scale
    wobble = amp * np.sin(2 * np.pi * freq * t + phase)
    sway = 0.01 * np.sin(2 * np.pi * 0.25 * t[:, :, :1])
    return base[None] + wobble + sway


def synthetic_motion_contacts(n_frames: int, seed: int = 0,
                              motion_scale: float = 0.06,
                              step_period: int = 10,
                              impact_scale: float = 0.035,
                              decay: float = 4.0) -> np.ndarray:
    """(N, 15, 3) motion with footstrike contacts: the sinusoidal carrier
    plus a triangle-wave whole-body bob in depth (its velocity flips sign
    at every contact) and, from each contact frame on, a random
    per-joint kick decaying as exp(-decay * frames / step_period).
    step_period is in frames (10 is 2.5 steps/s at 25 fps)."""
    rng = np.random.default_rng(seed + 13)
    out = synthetic_motion(n_frames, seed, motion_scale=motion_scale)
    t = np.arange(n_frames)
    phase = (t % step_period) / step_period
    bob = impact_scale * (1.0 - 2.0 * np.abs(phase - 0.5))
    out[:, :, 2] += bob[:, None]          # z = depth below the head camera
    contacts = np.nonzero(np.diff(phase) < 0)[0] + 1
    for c in contacts:
        kick = rng.normal(scale=impact_scale, size=(15, 3))
        env = np.exp(-decay * np.arange(n_frames - c) / step_period)
        out[c:] += kick[None] * env[:, None, None]
    return out


def dropout_heatmaps(maps: np.ndarray, seed: int = 0,
                     rate: float = 0.2, min_run: int = 5,
                     max_run: int = 20,
                     floor: float = 0.01) -> np.ndarray:
    """Occlusion dropout of (N, H, W, J) maps: per joint, runs of
    uniform(min_run, max_run) frames where the map is the constant
    `floor` (no peak at all), started with probability rate / mean run a
    frame, so that about `rate` of the cells drop.  The floor keeps the
    map's mass positive, so the crop-mass guard sees the dropout."""
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


def perturb_camera_trajectory(cams: np.ndarray, seed: int = 0,
                              drift_rot: float = 0.03,
                              drift_trans: float = 0.05,
                              jitter_rot: float = 0.008,
                              jitter_trans: float = 0.008) -> np.ndarray:
    """SLAM-like error on (N, 4, 4) cam->world matrices: a random-walk
    drift (its end-of-sequence size `drift_*`) plus per-frame jitter
    (`jitter_*`), in radians of yaw and tilt about the camera centre and
    in metres added to the translation."""
    rng = np.random.default_rng(seed + 7)
    n = len(cams)
    walk = lambda scale, shape: np.cumsum(  # noqa: E731
        rng.normal(scale=scale / np.sqrt(max(n, 1)), size=shape), axis=0)
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


def _world2camera_np(points: np.ndarray,
                     camera: fisheye.FisheyeParams) -> np.ndarray:
    """float32 fisheye projection (..., 3) -> (..., 2) pixels, in the
    order of `ops/fisheye.py::world2camera`."""
    p = points.astype(np.float32)
    poly = camera.poly_w2c.detach().cpu().numpy().astype(np.float32)
    cx, cy = camera.center.detach().cpu().numpy().astype(np.float32)
    x, y, z = p[..., 0], p[..., 1], -p[..., 2]
    norm = np.maximum(np.sqrt(x * x + y * y), np.float32(1e-9))
    theta = np.arctan(z / norm)
    rho = np.zeros_like(theta)
    for c in poly[::-1]:
        rho = rho * theta + c
    inv = rho / norm
    return np.stack([x * inv + cx, y * inv + cy], axis=-1)


def render_heatmaps(local_pose: np.ndarray,
                    camera: fisheye.FisheyeParams | None = None,
                    size: int = 64, sigma_px: float = 1.5) -> np.ndarray:
    """Per-joint Gaussian heatmaps (N, H, W, J) on the 64x64 grid of the
    1024x1024 fisheye centre crop (x - 128, /16 downscale); the camera
    defaults to the built-in 'egosyn'."""
    if camera is None:
        camera = fisheye.default_camera("egosyn")
    n, j = local_pose.shape[0], local_pose.shape[1]
    p2d = _world2camera_np(local_pose.reshape(-1, 3), camera)
    hx = (p2d[:, 0] - 128.0) / 16.0
    hy = p2d[:, 1] / 16.0
    grid = np.arange(size)
    d2 = ((grid[None, None, :] - hx[:, None, None]) ** 2
          + (grid[None, :, None] - hy[:, None, None]) ** 2)
    maps = np.exp(-d2 / (2 * sigma_px ** 2)).astype(np.float32)
    return maps.reshape(n, j, size, size).transpose(0, 2, 3, 1)


def degrade_heatmaps(maps: np.ndarray, seed: int = 0,
                     occlusion_prob: float = 0.15,
                     distractor_prob: float = 0.15,
                     distractor_sigma: float = 2.5,
                     floor: float = 0.02) -> np.ndarray:
    """Mo2Cap2's failure modes on (N, H, W, J) maps, as a new array: with
    `occlusion_prob` a (frame, joint) map is flattened towards uniform
    (0.05 x map + floor), with `distractor_prob` a second Gaussian of
    comparable mass appears at a random place, and `floor` is added
    everywhere."""
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


def synthetic_chunk(n_frames: int = 100, seed: int = 0,
                    noise_std: float = 0.03,
                    camera: fisheye.FisheyeParams | None = None,
                    cam_noise: dict | None = None,
                    degrade: dict | None = None,
                    motion_scale: float = 0.05,
                    freq_range: tuple = (0.3, 1.2),
                    motion: np.ndarray | None = None,
                    heat_transform=None) -> TestChunk:
    """One chunk in the test_data.pkl contract: the estimate is the true
    local pose plus white noise, the heatmaps peak at the true
    projections through `camera` ('egosyn' by default).

    cam_noise: keyword arguments of `perturb_camera_trajectory` ({} for
    its defaults, None for exact cameras); `camera_poses` and the
    estimated global pose then carry the error, while `gt_global` stays
    in the true frame.  degrade: keyword arguments of `degrade_heatmaps`
    (None: off).  motion_scale / freq_range pass to `synthetic_motion`;
    motion, a precomputed (N, 15, 3) true local motion, replaces it.
    heat_transform: (maps, seed) -> maps, applied after `degrade`."""
    rng = np.random.default_rng(seed + 2)
    local_true = (motion if motion is not None else
                  synthetic_motion(n_frames, seed,
                                   motion_scale=motion_scale,
                                   freq_range=freq_range))
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
    if heat_transform is not None:
        heat = heat_transform(heat, seed)
    return TestChunk(
        estimated_local=est_local,
        estimated_global=est_global.astype(np.float32),
        gt_global=gt_global.astype(np.float32),
        camera_poses=cams.astype(np.float32),
        heatmaps=heat,
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


def synthetic_chunk_v2(n_frames: int = 100, seed: int = 0,
                       noise_std: float = 0.03,
                       camera: fisheye.FisheyeParams | None = None
                       ) -> TestChunk:
    """The second evaluation regime: jerky motion (scale 0.10, up to
    2.5 Hz), SLAM drift and jitter on the cameras (the defaults of
    `perturb_camera_trajectory`) and degraded maps (the defaults of
    `degrade_heatmaps`: occlusion flattening, distractors, a floor)."""
    return synthetic_chunk(n_frames, seed, noise_std=noise_std,
                           camera=camera, cam_noise={}, degrade={},
                           motion_scale=0.10, freq_range=(0.5, 2.5))


def synthetic_chunk_v3(n_frames: int = 100, seed: int = 0,
                       noise_std: float = 0.03,
                       camera: fisheye.FisheyeParams | None = None
                       ) -> TestChunk:
    """The third evaluation regime: footstrike contacts
    (`synthetic_motion_contacts`), camera jitter without drift, and
    occlusion dropout of the maps (`dropout_heatmaps`), whose floor
    pulls the crop-mass coverage below the guard's bar."""
    motion = synthetic_motion_contacts(n_frames, seed)
    return synthetic_chunk(
        n_frames, seed, noise_std=noise_std, camera=camera,
        cam_noise={"drift_rot": 0.0, "drift_trans": 0.0,
                   "jitter_rot": 0.008, "jitter_trans": 0.008},
        motion=motion,
        heat_transform=lambda m, s: dropout_heatmaps(m, s))
