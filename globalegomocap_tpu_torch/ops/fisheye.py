"""Calibrated omnidirectional (Scaramuzza-style) fisheye camera.

Counterpart of `globalegomocap_tpu/ops/fisheye.py`: the W2C projection
and the C2W unprojection with the reference's z-flip convention
(`world2camera`, `camera2world`, `undistort`), the analytic equisolid
model, the two built-in calibration tables (published constants of the
two egocentric rigs) and calibration JSON files (`load_calibration`).
Parameters live on one device: move them with `.to(device)` once, next
to the points they serve.  Everything runs in float32, in the JAX
package's order of operations (Horner's rule from the highest
coefficient), so that a lifted pose agrees with JAX's to float32
rounding: the C2W polynomial's terms reach about 400 at the rim and
cancel down to about 200.
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


def camera2world(params: FisheyeParams, points2d: torch.Tensor,
                 depth: torch.Tensor) -> torch.Tensor:
    """Unproject pixels (..., 2) at per-point depth (...,) to camera-space
    points (..., 3): z from the C2W polynomial of the radial pixel
    distance, the ray [x, y, -z] normalised and scaled by depth."""
    centered = points2d - params.center
    x = centered[..., 0]
    y = centered[..., 1]
    z = _polyval_ascending(params.poly_c2w, torch.sqrt(x * x + y * y))
    ray = torch.stack([x, y, -z], dim=-1)
    norm = torch.sqrt((ray * ray).sum(-1, keepdim=True))
    return ray / norm * depth[..., None]


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


def world2camera_with_depth(params: FisheyeParams, points3d: torch.Tensor):
    """Project and also return the ray length as depth: ((..., 2),
    (...,))."""
    return world2camera(params, points3d), \
        torch.sqrt((points3d * points3d).sum(-1))


def undistort(params: FisheyeParams, points2d: torch.Tensor,
              focal: float = 500.0) -> torch.Tensor:
    """Fisheye pixels (..., 2) to an ideal pinhole image: a unit-depth
    unprojection, then a pinhole projection at `focal` about the
    calibration's centre."""
    p3d = camera2world(params, points2d, torch.ones_like(points2d[..., 0]))
    x = p3d[..., 0] / p3d[..., 2]
    y = p3d[..., 1] / p3d[..., 2]
    return torch.stack([focal * x + params.center[0],
                        focal * y + params.center[1]], dim=-1)


@dataclass(frozen=True)
class EquisolidParams:
    """Analytic equisolid fisheye, r = 2 f sin(theta / 2), as float32
    tensors."""
    focal_px: torch.Tensor    # () focal length in pixels
    center: torch.Tensor      # (2,) (cx, cy)
    max_radius: torch.Tensor  # () f sqrt(2), the r of theta = 90 degrees

    def to(self, device) -> "EquisolidParams":
        return EquisolidParams(*(t.to(device) for t in (
            self.focal_px, self.center, self.max_radius)))


def equisolid(focal_length_mm: float = 9.0, sensor_size_mm: float = 32.0,
              img_size=(1280, 1024)) -> EquisolidParams:
    """The reference's default equisolid camera (the `Skeleton(None)`
    default), its constants rounded to float32 as the JAX package's."""
    img = np.asarray(img_size, dtype=np.float32)
    focal_px = focal_length_mm / np.max(sensor_size_mm) * np.max(img)
    f32 = lambda v: torch.as_tensor(  # noqa: E731
        np.asarray(v, dtype=np.float32))
    return EquisolidParams(focal_px=f32(focal_px),
                           center=f32(img / 2 + 1e-10),
                           max_radius=f32(focal_px * np.sqrt(2.0)))


def equisolid_camera2world(params: EquisolidParams, points2d: torch.Tensor,
                           depth: torch.Tensor) -> torch.Tensor:
    """Unproject with the equisolid model: radii past max_radius - 30
    clamp to max_radius, theta = 2 asin(r / 2f), Z = r / tan(theta), the
    ray [x, y, Z] normalised and scaled by depth."""
    centered = points2d - params.center
    x = centered[..., 0]
    y = centered[..., 1]
    r = torch.sqrt(x * x + y * y)
    r = torch.where(r > params.max_radius - 30.0, params.max_radius, r)
    theta = 2.0 * torch.asin(r / (2.0 * params.focal_px))
    ray = torch.stack([x, y, r / torch.tan(theta)], dim=-1)
    norm = torch.sqrt((ray * ray).sum(-1, keepdim=True))
    return ray / norm * depth[..., None]


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
