"""Blender <-> OpenCV camera coordinate conversions, host numpy.

Counterpart of `globalegomocap_tpu/ops/blender.py` (reference:
utils/utils.py:141-249): world->cv extrinsics from a Blender camera's
location and XYZ Euler rotation, relative transforms between two
cameras, and a window's cameras chained onto the previous window's last
camera.  These run in data generation, on the host.
"""

from __future__ import annotations

import numpy as np
from scipy.spatial.transform import Rotation

# Blender's camera looks down -Z with +Y up; OpenCV's down +Z with -Y up.
_R_BCAM2CV = np.array([[1.0, 0.0, 0.0],
                       [0.0, -1.0, 0.0],
                       [0.0, 0.0, -1.0]])


def _world2cam(location, rotation_euler_xyz):
    loc = np.asarray(location, dtype=np.float64)
    r = Rotation.from_euler("xyz", rotation_euler_xyz,
                            degrees=False).as_matrix().T
    return r, -r @ loc


def _pack(r, t):
    mat = np.eye(4)
    mat[:3, :3] = r
    mat[:3, 3] = t
    return t, r, mat


def cv_rt_from_blender(location, rotation_euler_xyz):
    """A Blender camera pose -> (T_world2cv, R_world2cv, 4x4 world->cv)."""
    r, t = _world2cam(location, rotation_euler_xyz)
    return _pack(_R_BCAM2CV @ r, _R_BCAM2CV @ t)


def cv_rt_from_cv(location, rotation_euler_xyz):
    """The same construction without Blender's axis flip."""
    return _pack(*_world2cam(location, rotation_euler_xyz))


def relative_transform_from_blender(location1, rotation1, location2,
                                    rotation2):
    """Camera 2 relative to camera 1 in CV coordinates: (euler_xyz,
    translation, 4x4 cv2->cv1)."""
    _, _, m1 = cv_rt_from_blender(location1, rotation1)
    _, _, m2 = cv_rt_from_blender(location2, rotation2)
    cv2_to_cv1 = np.linalg.inv(np.linalg.inv(m1) @ m2)
    euler = Rotation.from_matrix(cv2_to_cv1[:3, :3]).as_euler("xyz")
    return euler, cv2_to_cv1[:3, 3], cv2_to_cv1


def consecutive_global_cameras(cam_seq: np.ndarray,
                               last_cam: np.ndarray) -> np.ndarray:
    """A window's (N, 4, 4) cameras chained onto the previous window's
    last camera: C_i' = last C_0^-1 C_i."""
    cam_seq = np.asarray(cam_seq)
    inv0 = np.linalg.inv(cam_seq[0])
    return np.einsum("ij,jk,nkl->nil", last_cam, inv0, cam_seq)
