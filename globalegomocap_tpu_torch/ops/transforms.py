"""SE(3) pose transforms, batched over windows and chunks.

Counterpart of `globalegomocap_tpu/ops/transforms.py`.  The products are
4x4 and run in full float32 (device.py pins matmul precision).
"""

from __future__ import annotations

import torch


def transform_pose(pose: torch.Tensor, matrix: torch.Tensor):
    """p' = R p + t.  pose (..., J, 3); matrix (..., 4, 4) broadcastable
    against pose's leading axes."""
    rot = matrix[..., :3, :3]
    trans = matrix[..., :3, 3]
    return torch.matmul(pose, rot.transpose(-1, -2)) + trans[..., None, :]


def invert_se3(matrix: torch.Tensor) -> torch.Tensor:
    """[R t]^-1 = [R^T  -R^T t]."""
    rot_t = matrix[..., :3, :3].transpose(-1, -2)
    new_t = -torch.matmul(rot_t, matrix[..., :3, 3:4])
    out = torch.zeros_like(matrix)
    out[..., :3, :3] = rot_t
    out[..., :3, 3:4] = new_t
    out[..., 3, 3] = 1.0
    return out


def relative_global_pose(local_pose_seq: torch.Tensor,
                         camera_matrix_seq: torch.Tensor) -> torch.Tensor:
    """Every frame's camera-space pose (..., T, J, 3) in the window's
    first camera frame: pose_i' = inv(C_0) C_i pose_i."""
    cam0_inv = invert_se3(camera_matrix_seq[..., 0:1, :, :])
    return transform_pose(local_pose_seq,
                          torch.matmul(cam0_inv, camera_matrix_seq))


def relative_to_global_pose(relative_pose_seq: torch.Tensor,
                            camera_matrix_0: torch.Tensor) -> torch.Tensor:
    """Push a relative-global window (..., T, J, 3) back to the world with
    the window's first camera matrix (..., 4, 4)."""
    return transform_pose(relative_pose_seq,
                          camera_matrix_0[..., None, :, :])
