"""Calibrated omnidirectional (Scaramuzza-style) fisheye camera.

Counterpart of `globalegomocap_tpu/ops/fisheye.py`: the W2C projection
with the reference's z-flip convention, the two built-in calibration
tables (published constants of the two egocentric rigs) and calibration
JSON files (`load_calibration`).
"""

from __future__ import annotations

import json
from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True)
class FisheyeParams:
    """Camera parameters as float32 tensors."""
    center: torch.Tensor     # (2,) image centre (cx, cy) in pixels
    poly_c2w: torch.Tensor   # ascending polynomial rho(pixel radius) -> z
    poly_w2c: torch.Tensor   # ascending polynomial theta -> image radius
    img_size: torch.Tensor   # (w, h) in pixels

    def to(self, device) -> "FisheyeParams":
        return FisheyeParams(*(t.to(device) for t in (
            self.center, self.poly_c2w, self.poly_w2c, self.img_size)))


CALIBRATION_KEYS = ("intrinsic", "size", "polynomialC2W", "polynomialW2C")


def load_calibration(path: str) -> FisheyeParams:
    """A fisheye calibration JSON (keys intrinsic, size, polynomialC2W,
    polynomialW2C: the reference's calibration file contract).  A file
    without one of them raises ValueError naming it."""
    with open(path) as f:
        data = json.load(f)
    missing = [k for k in CALIBRATION_KEYS if k not in data]
    if missing:
        raise ValueError(f"{path}: calibration lacks {missing}")
    return params_from_dict(data)


def params_from_dict(data: dict) -> FisheyeParams:
    intrinsic = np.asarray(data["intrinsic"], dtype=np.float32)
    f32 = lambda v: torch.as_tensor(  # noqa: E731
        np.asarray(v, dtype=np.float32))
    return FisheyeParams(
        center=f32([intrinsic[0][2], intrinsic[1][2]]),
        poly_c2w=f32(data["polynomialC2W"]),
        poly_w2c=f32(data["polynomialW2C"]),
        img_size=f32(data["size"]),
    )


def _polyval_ascending(coeffs: torch.Tensor, x: torch.Tensor):
    """sum_i coeffs[i] x**i by Horner, in the promoted dtype of the two:
    float32 coefficients lift a bf16 x to float32, as the JAX package's
    non-weak coefficient scalars do."""
    x = x.to(torch.promote_types(x.dtype, coeffs.dtype))
    out = torch.zeros_like(x)
    for c in coeffs.flip(0):
        out = out * x + c
    return out


def world2camera(params: FisheyeParams, points3d: torch.Tensor):
    """Project camera-space points (..., 3) to fisheye pixels (..., 2):
    theta = atan(-z / ||xy||), rho = poly_w2c(theta), scale the unit xy
    direction, ||xy|| clamped at 1e-9 as in the JAX package.  A point on
    the optical axis (x = y = 0, as a bf16 decode can give) has no xy
    direction: it projects to the image centre, as in the JAX package,
    with a zero gradient, where the JAX package's sqrt gives NaN."""
    x = points3d[..., 0]
    y = points3d[..., 1]
    z = -points3d[..., 2]
    axis = (x == 0) & (y == 0)
    one = torch.ones_like(x)
    x, y = torch.where(axis, one, x), torch.where(axis, one, y)
    safe_norm = torch.sqrt(x * x + y * y).clamp_min(1e-9)
    theta = torch.atan(z / safe_norm)
    inv = _polyval_ascending(params.poly_w2c, theta) / safe_norm
    zero = torch.zeros_like(inv)
    return torch.stack([torch.where(axis, zero, x * inv) + params.center[0],
                        torch.where(axis, zero, y * inv) + params.center[1]],
                       dim=-1)


EGOSYN_CALIBRATION = {
    "name": "egosyn",
    "size": [1280, 1024],
    "intrinsic": [
        [500, 0, 6.597087109684564E+02, 0],
        [0, 500, 5.300556618148025E+02, 0],
        [0, 0, 1, 0],
        [0, 0, 0, 1],
    ],
    "imageCircleRadius": 512.0,
    "polynomialC2W": [-2.924126419694919E+02, 0.0, 1.075613595858202E-03,
                      2.072664555244253E-07, 4.493499097653669E-10,
                      -1.192028310212584E-15, -1.822337421183959E-17],
    "polynomialW2C": [4.785893205484341E+02, 3.503715828980770E+02,
                      7.900065565120241E+01, 6.228794005673283E+01,
                      3.264466851189552E+01, 1.568380500967838E+01,
                      7.766879336977007E+00, 2.190791369989537E+00,
                      -1.084229689289942E-01, -1.903842667463734E-01,
                      -2.776267870029922E-02],
}

POSE_FISHEYE_CALIBRATION = {
    "name": "new",
    "size": [1280, 1024],
    "intrinsic": [
        [500, 0, 639.074101, 0],
        [0, 500, 511.081780, 0],
        [0, 0, 1, 0],
        [0, 0, 0, 1],
    ],
    "imageCircleRadius": 512.0,
    "polynomialC2W": [-4.083907e+02, 0.0, 1.679882e-03, -3.677087e-06,
                      7.461604e-09],
    "polynomialW2C": [492.969845, 193.289959, -28.612327, 51.744505,
                      -2.120082, 13.644155, 1.512262, -18.789714, 18.962317,
                      14.989157, -12.692345, -5.804379, 3.508978, 1.511979],
}


def default_camera(name: str = "egosyn") -> FisheyeParams:
    """A built-in calibrated camera ('egosyn' or 'pose_fisheye')."""
    table = {"egosyn": EGOSYN_CALIBRATION,
             "pose_fisheye": POSE_FISHEYE_CALIBRATION}
    return params_from_dict(table[name])
