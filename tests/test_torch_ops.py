"""The port's geometry and window ops against the JAX package on the same
numpy inputs (rtol 1e-5, atol 1e-6)."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from globalegomocap_tpu.ops import filtering as jfilt
from globalegomocap_tpu.ops import fisheye as jfish
from globalegomocap_tpu.ops import skeleton as jskel
from globalegomocap_tpu.ops import transforms as jtr
from globalegomocap_tpu.optimize import window as jwin
from globalegomocap_tpu_torch.ops import filtering as tfilt
from globalegomocap_tpu_torch.ops import fisheye as tfish
from globalegomocap_tpu_torch.ops import skeleton as tskel
from globalegomocap_tpu_torch.ops import transforms as ttr
from globalegomocap_tpu_torch.optimize import window as twin

TOL = dict(rtol=1e-5, atol=1e-6)
RNG = np.random.default_rng(0)


def _close(t, j, **tol):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **(tol or TOL))


def _poses(*lead):
    base = (jskel.MEAN3D_MM.T / 1000.0).astype(np.float32)
    return (base + RNG.normal(scale=0.05, size=lead + (15, 3))
            ).astype(np.float32)


def _rigid(n):
    """n random cam->world matrices (rotation from a QR, translation)."""
    out = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    for i in range(n):
        q, r = np.linalg.qr(RNG.normal(size=(3, 3)))
        q *= np.sign(np.diag(r))
        out[i, :3, :3] = q
        out[i, :3, 3] = RNG.normal(size=3)
    return out


def test_skeleton_tables_and_bone_lengths():
    assert tskel.KINEMATIC_PARENTS == tuple(jskel.KINEMATIC_PARENTS)
    np.testing.assert_array_equal(tskel.MEAN3D_MM, jskel.MEAN3D_MM)
    x = _poses(4, 10)
    x[0, 0, 5] = x[0, 0, 4]               # a zero-length bone
    _close(tskel.bone_lengths(torch.from_numpy(x)),
           jskel.bone_lengths(jnp.asarray(x)))
    _close(tskel.mean_bone_lengths(torch.from_numpy(x)),
           jskel.mean_bone_lengths(jnp.asarray(x)))
    # zero-safe: the zero-length bone has a finite (zero) gradient
    xt = torch.from_numpy(x).requires_grad_(True)
    (g,) = torch.autograd.grad(tskel.bone_lengths(xt).sum(), xt)
    assert torch.isfinite(g).all()


@pytest.mark.parametrize("name", ["egosyn", "pose_fisheye"])
def test_fisheye_tables_and_projection(name):
    jc, tc = jfish.default_camera(name), tfish.default_camera(name)
    for field in ("center", "poly_c2w", "poly_w2c", "img_size"):
        np.testing.assert_array_equal(getattr(tc, field).numpy(),
                                      np.asarray(getattr(jc, field)))
    p = _poses(6, 10)
    p[0, 0, 0, :2] = 0.0                  # on the optical axis: clamped
    _close(tfish.world2camera(tc, torch.from_numpy(p)),
           jfish.world2camera(jc, jnp.asarray(p)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fisheye_gradient_is_finite_on_the_optical_axis(dtype):
    """A joint exactly on the axis (x = y = 0, as a bf16 decode can give)
    projects to the image centre, as in the JAX package, with a gradient
    of exactly 0, where the JAX package's sqrt gives NaN; the clamped
    norm alone would give d/dx = poly_w2c(theta) / 1e-9, about 1e11.  The
    other points' gradients agree with the JAX package's."""
    jc, tc = jfish.default_camera("egosyn"), tfish.default_camera("egosyn")
    p = np.array([[0.0, 0.0, 0.5], [0.0, 0.0, -0.3], [0.1, -0.2, 0.6],
                  [0.0, 0.3, 0.4]], np.float32)
    x = torch.from_numpy(p).to(dtype).requires_grad_(True)
    out = tfish.world2camera(tc, x)
    (g,) = torch.autograd.grad(out.float().sum(), x)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jp = jnp.asarray(p, jdt)
    jout = np.asarray(jfish.world2camera(jc, jp).astype(jnp.float32))
    _close(out.detach().float(), jout)
    np.testing.assert_array_equal(out[:2].detach().float().numpy(),
                                  np.broadcast_to(tc.center.numpy(), (2, 2)))
    jg = np.asarray(jax.grad(lambda v: jfish.world2camera(jc, v).astype(
        jnp.float32).sum())(jp), np.float32)
    assert np.isnan(jg[:2, :2]).all()
    np.testing.assert_array_equal(g[:2].float().numpy(), 0.0)
    tol = TOL if dtype == torch.float32 else dict(rtol=2e-2, atol=0)
    _close(g[2:].float(), jg[2:], **tol)


def test_transforms():
    cams = _rigid(2 * 10).reshape(2, 10, 4, 4)
    p = _poses(2, 10)
    tc, jc = torch.from_numpy(cams), jnp.asarray(cams)
    tp, jp = torch.from_numpy(p), jnp.asarray(p)
    _close(ttr.transform_pose(tp, tc), jtr.transform_pose(jp, jc))
    _close(ttr.invert_se3(tc), jtr.invert_se3(jc))
    _close(ttr.relative_global_pose(tp, tc),
           jtr.relative_global_pose(jp, jc))
    _close(ttr.relative_to_global_pose(tp, tc[:, 0]),
           jtr.relative_to_global_pose(jp, jc[:, 0]))


@pytest.mark.parametrize("n", [10, 26, 100])
def test_windows(n):
    assert twin.num_windows(n) == jwin.num_windows(n)
    np.testing.assert_array_equal(twin.window_indices(n),
                                  jwin.window_indices(n))
    x = _poses(n)
    _close(twin.slice_windows(torch.from_numpy(x)),
           jwin.slice_windows(jnp.asarray(x)), rtol=0, atol=0)
    # a leading chunk axis: windows along dim 1
    xc = _poses(3, n)
    got = twin.slice_windows(torch.from_numpy(xc), dim=1)
    for c in range(3):
        _close(got[c], jwin.slice_windows(jnp.asarray(xc[c])), rtol=0,
               atol=0)


@pytest.mark.parametrize("sigma", [0.0, 1.0, 2.5])
@pytest.mark.parametrize("w", [1, 3, 12])
def test_merge_matrix_and_merge(w, sigma):
    np.testing.assert_allclose(twin.merge_matrix(w, 10, 8, sigma),
                               jwin.merge_matrix(w, 10, 8, sigma), **TOL)
    x = _poses(2, w, 10)
    got = twin.merge_windows_matmul(torch.from_numpy(x), 8, sigma,
                                    batch_dims=1)
    for c in range(2):
        _close(got[c], jwin.merge_windows_matmul(jnp.asarray(x[c]), 8,
                                                 sigma))


def test_merge_with_folded_sigma_is_merge_then_smooth():
    x = _poses(5, 10)
    merged = twin.merge_windows_matmul(torch.from_numpy(x), 8, 1.0)
    plain = twin.merge_windows_matmul(torch.from_numpy(x), 8, 0.0)
    _close(merged, jfilt.gaussian_filter1d(jnp.asarray(plain.numpy()), 1.0,
                                           axis=0))
    _close(tfilt.gaussian_filter1d(plain, 1.0, dim=0),
           jfilt.gaussian_filter1d(jnp.asarray(plain.numpy()), 1.0, axis=0))
    np.testing.assert_array_equal(tfilt._gaussian_kernel(1.0),
                                  jfilt._gaussian_kernel(1.0))
