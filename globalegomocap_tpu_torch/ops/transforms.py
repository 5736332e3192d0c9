"""SE(3) pose transforms, batched over windows and chunks.

Counterpart of `globalegomocap_tpu/ops/transforms.py`.  The products are
4x4 and run in full float32 (device.py pins matmul precision).
"""

from __future__ import annotations

import torch


def transform_pose(pose: torch.Tensor, matrix: torch.Tensor):
    """p' = R p + t.  pose (..., J, 3); matrix (..., 4, 4) broadcastable
    against pose's leading axes.  Mixed dtypes promote (a bf16 pose and a
    float32 matrix give float32)."""
    dt = torch.promote_types(pose.dtype, matrix.dtype)   # as jnp.einsum
    rot = matrix[..., :3, :3].to(dt)
    trans = matrix[..., :3, 3].to(dt)
    return torch.matmul(pose.to(dt), rot.transpose(-1, -2)) \
        + trans[..., None, :]


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


def quat_to_rotmat(quat: torch.Tensor) -> torch.Tensor:
    """Quaternions (..., 4) in scipy's (x, y, z, w) order, not necessarily
    normalised, to rotation matrices (..., 3, 3), as scipy's
    `Rotation.from_quat(q).as_matrix()`."""
    q = quat / torch.linalg.vector_norm(quat, dim=-1, keepdim=True)
    x, y, z, w = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = torch.stack([
        1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
        2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
        2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)], dim=-1)
    return m.reshape(*q.shape[:-1], 3, 3)


def quat_trans_to_matrix(trans: torch.Tensor,
                         quat: torch.Tensor) -> torch.Tensor:
    """4x4 camera-to-world matrices from translations (..., 3) and
    quaternions (..., 4) in scipy's (x, y, z, w) order."""
    rot = quat_to_rotmat(quat)
    batch = torch.broadcast_shapes(trans.shape[:-1], quat.shape[:-1])
    out = torch.zeros(batch + (4, 4), dtype=rot.dtype, device=rot.device)
    out[..., :3, :3] = rot
    out[..., :3, 3] = trans
    out[..., 3, 3] = 1.0
    return out


def rotmat_to_quat(rot: torch.Tensor) -> torch.Tensor:
    """Rotation matrices (..., 3, 3) to unit quaternions (..., 4) in
    scipy's (x, y, z, w) order, up to the quaternion's double cover:
    Shepperd's magnitudes from the diagonal, each vector sign from the
    skew part by copysign (w >= 0)."""
    m = rot
    m00, m11, m22 = m[..., 0, 0], m[..., 1, 1], m[..., 2, 2]
    t = m00 + m11 + m22
    zero = torch.zeros_like(t)
    qw = torch.sqrt(torch.maximum(zero, 1 + t)) / 2
    qx = torch.sqrt(torch.maximum(zero, 1 + m00 - m11 - m22)) / 2
    qy = torch.sqrt(torch.maximum(zero, 1 - m00 + m11 - m22)) / 2
    qz = torch.sqrt(torch.maximum(zero, 1 - m00 - m11 + m22)) / 2
    qx = torch.copysign(qx, m[..., 2, 1] - m[..., 1, 2])
    qy = torch.copysign(qy, m[..., 0, 2] - m[..., 2, 0])
    qz = torch.copysign(qz, m[..., 1, 0] - m[..., 0, 1])
    q = torch.stack([qx, qy, qz, qw], dim=-1)
    return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
