"""Fisheye epipolar geometry: the essential matrix from unit rays, its
decomposition, two-view midpoint triangulation and pose recovery by
cheirality.

Counterpart of `globalegomocap_tpu/ops/epipolar.py` (the reference's
external-camera experiments, utils/fisheye/fisheye_epipolar_geometry.py).
Convention (Hartley & Zisserman): camera 1 is [I|0], camera 2 is [R|t]
(x2 = R x1 + t), E = [t]x R with x2' E x1 = 0.  Pixels unproject to unit
rays through the camera model, so any central camera shares the
pipeline.  The SVD's null vector has no fixed sign, so E is defined up
to sign; R, t and the points after cheirality are not.
"""

from __future__ import annotations

import torch

from globalegomocap_tpu_torch.ops import fisheye


def _unit(v: torch.Tensor) -> torch.Tensor:
    return v / torch.linalg.vector_norm(v, dim=-1, keepdim=True)


def pixels_to_rays(params: fisheye.FisheyeParams,
                   points2d: torch.Tensor) -> torch.Tensor:
    """Fisheye pixels (..., 2) -> unit direction rays (..., 3)."""
    return _unit(fisheye.camera2world(params, points2d,
                                      torch.ones_like(points2d[..., 0])))


def essential_from_rays(rays1: torch.Tensor,
                        rays2: torch.Tensor) -> torch.Tensor:
    """8-point estimate of E from N >= 8 unit-ray pairs (N, 3): the
    least-squares null vector of the bilinear constraints, projected onto
    the essential manifold (two equal singular values, one zero)."""
    a = (rays2[:, :, None] * rays1[:, None, :]).reshape(-1, 9)
    _, _, vt = torch.linalg.svd(a)
    u, s, vt2 = torch.linalg.svd(vt[-1].reshape(3, 3))
    sigma = (s[0] + s[1]) / 2.0
    return u @ torch.diag(torch.stack([sigma, sigma, torch.zeros_like(
        sigma)])) @ vt2


def decompose_essential(E: torch.Tensor):
    """E = [t]x R -> the four (R, t) candidates, rotations proper,
    |t| = 1."""
    u, _, vt = torch.linalg.svd(E)
    u = u * torch.sign(torch.linalg.det(u))
    vt = vt * torch.sign(torch.linalg.det(vt))
    W = torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]],
                     dtype=E.dtype, device=E.device)
    R1 = u @ W @ vt
    R2 = u @ W.T @ vt
    t = u[:, 2]
    return (R1, t), (R1, -t), (R2, t), (R2, -t)


def triangulate_midpoint(rays1: torch.Tensor, rays2: torch.Tensor,
                         R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Midpoint triangulation under x2 = R x1 + t: the points (N, 3) in
    camera 1's coordinates (scale fixed by |t| = 1).  Camera 2's centre
    there is -R' t, its rays R' d2."""
    d1 = rays1
    d2 = rays2 @ R                              # R' d2 per row
    o2 = -(t @ R)                               # -R' t
    a = (d1 * d1).sum(-1)
    b = (d1 * d2).sum(-1)
    c = (d2 * d2).sum(-1)
    dd = (d1 * o2).sum(-1)
    e = (d2 * o2).sum(-1)
    denom = a * c - b * b
    denom = torch.where(denom.abs() > 1e-12, denom,
                        torch.full_like(denom, 1e-12))
    s = (c * dd - b * e) / denom
    u = (b * dd - a * e) / denom
    return (s[:, None] * d1 + o2 + u[:, None] * d2) / 2.0


def cheirality_score(rays1: torch.Tensor, rays2: torch.Tensor,
                     R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """The count of pairs whose point lies in front of both cameras."""
    X = triangulate_midpoint(rays1, rays2, R, t)
    depth1 = (X * rays1).sum(-1)
    depth2 = ((X @ R.T + t) * rays2).sum(-1)
    return ((depth1 > 0) & (depth2 > 0)).sum()


def recover_pose(rays1: torch.Tensor, rays2: torch.Tensor):
    """E, then the candidate (R, t) with the most points in front of both
    cameras (the first on a tie), then the points: (R, t, (N, 3))."""
    candidates = decompose_essential(essential_from_rays(rays1, rays2))
    scores = torch.stack([cheirality_score(rays1, rays2, R, t)
                          for R, t in candidates])
    R, t = candidates[int(torch.argmax(scores))]
    return R, t, triangulate_midpoint(rays1, rays2, R, t)


def pinhole_pixels_to_rays(K: torch.Tensor,
                           points2d: torch.Tensor) -> torch.Tensor:
    """Pinhole pixels (..., 2) -> unit rays (..., 3) through K^-1."""
    homo = torch.cat([points2d, torch.ones_like(points2d[..., :1])], dim=-1)
    return _unit(homo @ torch.linalg.inv(K[:3, :3]).T)


def recover_pose_fisheye_pinhole(fisheye_params: fisheye.FisheyeParams,
                                 points_fisheye: torch.Tensor, pinhole_K,
                                 points_pinhole: torch.Tensor):
    """Relative pose of an external pinhole camera to the egocentric
    fisheye from 2D-2D correspondences, both unprojected straight to unit
    rays (no undistortion resampling): (R, t, points) with x_pinhole =
    R x_fisheye + t, |t| = 1, the points in the fisheye's frame."""
    K = torch.as_tensor(pinhole_K, dtype=points_pinhole.dtype,
                        device=points_pinhole.device)
    return recover_pose(pixels_to_rays(fisheye_params, points_fisheye),
                        pinhole_pixels_to_rays(K, points_pinhole))
