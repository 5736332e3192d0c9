"""Captury studio multi-camera calibration files.

Counterpart of `globalegomocap_tpu/tools/captury_camera.py`, the port's
own copy of the reference's parser (utils/captury_studio_camera.py:
4-39): a Captury `.calib` text file holds one block per studio camera;
within a block, line 11 holds the distortion coefficients, lines 17-19
the 3x4 extrinsic and lines 21-23 the 3x3 intrinsic (the reference's
offsets 73-56 and 77-56 from the block start).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

_BLOCK_LEN = 27
_DISTORTION_LINE = 11
_EXTRINSIC_LINES = slice(73 - 56, 76 - 56)
_INTRINSIC_LINES = slice(77 - 56, 80 - 56)


@dataclass(frozen=True)
class CapturyCamera:
    intrinsic: np.ndarray   # (3, 3-4)
    extrinsic: np.ndarray   # (3, 4)
    distortion: np.ndarray  # (k,)


def load_captury_camera(camera_path: str, camera_number: int
                        ) -> CapturyCamera:
    with open(camera_path) as f:
        lines = f.readlines()
    start = -1
    for i, line in enumerate(lines):
        if f"camera\t{camera_number}" in line:
            start = i
            break
    if start == -1:
        raise ValueError(
            f"camera {camera_number} not found in {camera_path}")
    block = lines[start:start + _BLOCK_LEN]
    distortion = np.asarray(block[_DISTORTION_LINE].split()[1:],
                            dtype=np.float64)
    extrinsic = np.asarray([ln.split()[1:]
                            for ln in block[_EXTRINSIC_LINES]],
                           dtype=np.float64)
    intrinsic = np.asarray([ln.split()[1:]
                            for ln in block[_INTRINSIC_LINES]],
                           dtype=np.float64)
    return CapturyCamera(intrinsic=intrinsic, extrinsic=extrinsic,
                         distortion=distortion)
