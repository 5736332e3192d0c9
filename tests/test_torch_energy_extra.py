"""The energy library's remaining terms and crop helpers against the JAX
package's on the same numpy inputs: `reprojection_energy`,
`camera_matrix_energy` and `camera_constraint_energy` (values rtol 1e-5,
gradients against `jax.grad` rtol 1e-4 of the largest entry, over a
batch of windows that JAX takes one at a time), `crop_heatmaps` and
`crop_heatmaps_at_centers` equal to JAX's (half-integer centres
included: both round half to even), and `crop_mass_coverage` to 1e-12.

The constraint's rotation blocks are well conditioned (rotations plus
noise of 0.05): `torch.linalg.det`'s LU gradient and JAX's differ only
at a singular block."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from globalegomocap_tpu.energy import terms as jterms
from globalegomocap_tpu.ops import fisheye as jfish
from globalegomocap_tpu_torch.data.synthetic import (
    synthetic_camera_trajectory, synthetic_chunk_v2, synthetic_motion)
from globalegomocap_tpu_torch.energy import terms as tterms
from globalegomocap_tpu_torch.ops import fisheye as tfish

B, T = 3, 10


def _windows(seed):
    """(B, T, 15, 3) camera-frame poses, a (B, T, 15, 2) 2D estimate (the
    projection of a perturbed pose) and (B, T, 4, 4) cameras."""
    rng = np.random.default_rng(seed)
    pose = synthetic_motion(B * T, seed).reshape(B, T, 15, 3)
    pose = pose.astype(np.float32)
    est = pose + rng.normal(scale=0.02, size=pose.shape).astype(np.float32)
    est2d = np.array(jfish.world2camera(jfish.default_camera("egosyn"),
                                          jnp.asarray(est)))
    cams = synthetic_camera_trajectory(B * T, seed).reshape(B, T, 4, 4)
    cams = (cams + rng.normal(scale=0.05, size=cams.shape)).astype(
        np.float32)
    return pose, est2d, cams


def _value_and_grad_torch(fn, *args):
    x = torch.from_numpy(args[0]).requires_grad_(True)
    e = fn(x, *args[1:])
    e.sum().backward()
    return e.detach().numpy(), x.grad.numpy()


def _value_and_grad_jax(fn, *args):
    """JAX's energy of one window, vmapped over the B windows."""
    v, g = jax.jit(jax.vmap(jax.value_and_grad(fn)))(
        *(jnp.asarray(a) for a in args))
    return np.asarray(v), np.asarray(g)


def _hold(got, want):
    (v_t, g_t), (v_j, g_j) = got, want
    np.testing.assert_allclose(v_t, v_j, rtol=1e-5)
    np.testing.assert_allclose(g_t, g_j, rtol=0,
                               atol=1e-4 * np.abs(g_j).max())


@pytest.mark.parametrize("seed", [0, 1])
def test_reprojection_energy_matches_jax(seed):
    pose, est2d, _ = _windows(seed)
    tcam = tfish.default_camera("egosyn")
    jcam = jfish.default_camera("egosyn")
    got = _value_and_grad_torch(
        lambda x, e: tterms.reprojection_energy(x, e, tcam), pose,
        torch.from_numpy(est2d))
    want = _value_and_grad_jax(
        lambda x, e: jterms.reprojection_energy(x, e.reshape(-1, 2), jcam),
        pose, est2d)
    _hold(got, want)
    flat = tterms.reprojection_energy(torch.from_numpy(pose),
                                      torch.from_numpy(est2d).reshape(
                                          B, T * 15, 2), tcam)
    np.testing.assert_array_equal(flat.numpy(), got[0])


@pytest.mark.parametrize("seed", [0, 1])
def test_camera_matrix_energy_matches_jax(seed):
    _, _, cams = _windows(seed)
    init = cams + np.float32(0.01)
    got = _value_and_grad_torch(tterms.camera_matrix_energy, cams,
                                torch.from_numpy(init))
    want = _value_and_grad_jax(jterms.camera_matrix_energy, cams, init)
    _hold(got, want)


@pytest.mark.parametrize("seed", [0, 1])
def test_camera_constraint_energy_matches_jax(seed):
    _, _, cams = _windows(seed)
    dets = np.linalg.det(cams[..., :3, :3].astype(np.float64))
    assert np.abs(dets).min() > 0.5          # well conditioned
    got = _value_and_grad_torch(tterms.camera_constraint_energy, cams)
    want = _value_and_grad_jax(jterms.camera_constraint_energy, cams)
    _hold(got, want)
    exact = np.tile(np.eye(4, dtype=np.float32), (2, T, 1, 1))
    assert tterms.camera_constraint_energy(
        torch.from_numpy(exact)).abs().max() == 0


@pytest.fixture(scope="module")
def maps():
    """Degraded (multimodal, occluded) maps as (N, J, H, W)."""
    heat = synthetic_chunk_v2(12, seed=3).heatmaps
    return np.ascontiguousarray(np.moveaxis(heat, -1, 1))


@pytest.mark.parametrize("k", [8, 16, 70])
def test_crop_heatmaps_match_jax(maps, k):
    crops_t, org_t, hw_t = tterms.crop_heatmaps(torch.from_numpy(maps), k)
    crops_j, org_j, hw_j = jterms.crop_heatmaps(jnp.asarray(maps), k)
    assert tuple(hw_t) == tuple(hw_j)
    assert org_t.dtype == torch.float32
    np.testing.assert_array_equal(crops_t.numpy(), np.asarray(crops_j))
    np.testing.assert_array_equal(org_t.numpy(), np.asarray(org_j))


@pytest.mark.parametrize("k", [8, 16])
def test_crop_heatmaps_at_centers_match_jax(maps, k):
    """Centres with halves (x.5 rounds to even in both), out of range
    and negative ones (clipped)."""
    rng = np.random.default_rng(k)
    lead = maps.shape[:2]
    centers = rng.uniform(-8, 72, size=lead + (2,)).astype(np.float32)
    centers[0, :, 0] = np.arange(15) + 20.5
    centers[1, :, 1] = np.arange(15) * 3 + 0.5
    crops_t, org_t, _ = tterms.crop_heatmaps_at_centers(
        torch.from_numpy(maps), k, torch.from_numpy(centers))
    crops_j, org_j, _ = jterms.crop_heatmaps_at_centers(
        jnp.asarray(maps), k, jnp.asarray(centers))
    np.testing.assert_array_equal(org_t.numpy(), np.asarray(org_j))
    np.testing.assert_array_equal(crops_t.numpy(), np.asarray(crops_j))
    assert (org_t[0, :, 0] == torch.from_numpy(
        np.clip(np.round(centers[0, :, 0]) - k // 2, 0, 64 - k))).all()


@pytest.mark.parametrize("k", [4, 8, 16])
def test_crop_mass_coverage_matches_jax(maps, k):
    m = maps.copy()
    m[0, 0] = 0.0                    # no mass: covered
    m[1, 2] -= 0.5                   # negative values clip
    got = tterms.crop_mass_coverage(m, k)
    want = jterms.crop_mass_coverage(m, k)
    assert got.shape == (m.shape[0] * m.shape[1],)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    assert got[0] == 1.0
    dev = float(tterms.crop_coverage_mean(torch.from_numpy(maps), k))
    np.testing.assert_allclose(
        dev, tterms.crop_mass_coverage(maps, k).mean(), rtol=1e-5)
