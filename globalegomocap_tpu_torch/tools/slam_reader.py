"""OpenVSLAM trajectory reading with metric scale recovery.

Counterpart of `globalegomocap_tpu/tools/slam_reader.py` (the reference's
MakeDataForOptimization/slam_reader.py:11-200):

  1. parse `frame_trajectory.txt` (timestamp tx ty tz qx qy qz qw a
     line; the frame id is Python's round(timestamp * fps), half to
     even; lines of fewer than 8 fields are skipped; frames in the
     half-open window [start, end));
  2. re-base every pose on the window's first frame;
  3. recover monocular SLAM's unknown metric scale by Umeyama-fitting
     the SLAM-implied head trajectory (the local head pushed through
     each SLAM pose) to the ground-truth one, then scale the
     translations.

The file is read in float64 and the matrices, head trajectories and
both fits are computed in float32 on the given device (the JAX package
runs them in float32, x64 being off); results come back as numpy
float32.
"""

from __future__ import annotations

import numpy as np
import torch

from globalegomocap_tpu_torch.device import resolve_device
from globalegomocap_tpu_torch.ops.transforms import (
    invert_se3, quat_trans_to_matrix, transform_pose)
from globalegomocap_tpu_torch.ops.umeyama import umeyama


def parse_trajectory_file(path: str, fps: float, start_frame: int,
                          end_frame: int):
    """(trans (N, 3), quat (N, 4) xyzw), float64, of the frames in
    [start_frame, end_frame)."""
    trans_list, rot_list = [], []
    with open(path) as f:
        for line in f:
            parts = line.strip().split()
            if len(parts) < 8:
                continue
            frame_id = round(float(parts[0]) * fps)
            if start_frame <= frame_id < end_frame:
                trans_list.append([float(x) for x in parts[1:4]])
                rot_list.append([float(x) for x in parts[4:8]])
    return (np.asarray(trans_list, dtype=np.float64),
            np.asarray(rot_list, dtype=np.float64))


def rebase_to_first(mats: torch.Tensor) -> torch.Tensor:
    """Every cam->world matrix (N, 4, 4) relative to the first one."""
    return torch.matmul(invert_se3(mats[0])[None], mats)


def _matrices(path, fps, start_frame, end_frame, device) -> torch.Tensor:
    """The window's re-based float32 matrices on `device`."""
    trans, quat = parse_trajectory_file(path, fps, start_frame, end_frame)
    f32 = lambda a: torch.as_tensor(  # noqa: E731
        a, dtype=torch.float32, device=device)
    return rebase_to_first(quat_trans_to_matrix(f32(trans), f32(quat)))


def read_trajectory(path: str, fps: float, start_frame: int, end_frame: int,
                    scale: float = 1.0, device=None) -> np.ndarray:
    """The trajectory's re-based (N, 4, 4) matrices, translations scaled
    by a fixed factor.  Runs on the card unless device='cpu'."""
    mats = _matrices(path, fps, start_frame, end_frame,
                     resolve_device(device))
    mats[:, :3, 3] *= scale
    return mats.cpu().numpy()


def recover_metric_scale(rel_mats: torch.Tensor, local_pose_list,
                         gt_global_pose):
    """Umeyama scale recovery on `rel_mats`' device.

    rel_mats:        (N, 4, 4) re-based SLAM cam->world matrices.
    local_pose_list: (N, 15, 3) local pose estimates.
    gt_global_pose:  (N, 15, 3) ground-truth world poses.
    Returns (c (0-d float32 tensor), R_1, t_1 (numpy)), where (R_1, t_1)
    is the inverse fit (gt -> slam frame) the reference also returns."""
    f32 = lambda a: torch.as_tensor(  # noqa: E731
        np.asarray(a, dtype=np.float32), device=rel_mats.device)
    slam_heads = transform_pose(f32(local_pose_list), rel_mats)[:, 0, :]
    gt_heads = f32(gt_global_pose)[:, 0, :]
    c, _, _ = umeyama(slam_heads, gt_heads)
    _, R1, t1 = umeyama(gt_heads, slam_heads)
    return c, R1.cpu().numpy(), t1.cpu().numpy()


def read_trajectory_with_scale(path: str, fps: float, local_pose_list,
                               gt_global_pose, start_frame: int,
                               end_frame: int, device=None):
    """The reference's `read_trajectory_new`: parse, re-base, recover the
    head trajectory's scale.  Returns (matrices (N, 4, 4) with scaled
    translations, R_1, t_1) as numpy float32.  Runs on the card unless
    device='cpu'."""
    rel = _matrices(path, fps, start_frame, end_frame,
                    resolve_device(device))
    c, R1, t1 = recover_metric_scale(rel, local_pose_list, gt_global_pose)
    rel[:, :3, 3] *= c
    return rel.cpu().numpy(), R1, t1
