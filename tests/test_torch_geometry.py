"""The port's new geometry against the JAX package on the CPU: fisheye
`camera2world`, `world2camera_with_depth`, `undistort` and the equisolid
model; `rotmat_to_quat`; the Umeyama variants (scale only, no centering,
RANSAC); and `ops/epipolar.py`.  The same numpy inputs from a seed go
through both packages.

Tolerances: camera2world runs in float32 in JAX's order of operations,
so the two agree to float32 rounding (5.5e-7 relative measured on radii
up to 680 px; held at 2e-6); the SVD-based fits at rtol 1e-4, atol 1e-5
(two float32 LAPACK paths); the SVD's sign freedom is taken out where it
is free (E, the quaternion's double cover) and held where it is not
(R, t and the points after cheirality)."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from globalegomocap_tpu.ops import epipolar as jep
from globalegomocap_tpu.ops import fisheye as jfe
from globalegomocap_tpu.ops import transforms as jtr
from globalegomocap_tpu_torch.ops import epipolar as tep
from globalegomocap_tpu_torch.ops import fisheye as tfe
from globalegomocap_tpu_torch.ops import transforms as ttr
import tests.torch_port_helpers  # noqa: F401  (one intra-op thread)

# the modules, not the functions the JAX package's ops/__init__ exports
# under the same name
jum = importlib.import_module("globalegomocap_tpu.ops.umeyama")
tum = importlib.import_module("globalegomocap_tpu_torch.ops.umeyama")


def t(a):
    return torch.tensor(np.asarray(a, dtype=np.float32))


def pixels_around(center, n, max_radius, seed):
    """n pixels at uniform angles and radii up to max_radius."""
    rng = np.random.default_rng(seed)
    ang = rng.uniform(0, 2 * np.pi, n)
    rad = rng.uniform(0, max_radius, n)
    return (np.asarray(center) + np.stack(
        [rad * np.cos(ang), rad * np.sin(ang)], 1)).astype(np.float32)


# ---------------------------------------------------------------------------
# fisheye
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["egosyn", "pose_fisheye"])
def test_camera2world_matches_jax(name):
    """Radii up to 680 px (the lift's pixels reach about 675), where the
    C2W polynomial's terms reach about 400 and cancel down to about 200."""
    jc, tc = jfe.default_camera(name), tfe.default_camera(name)
    px = pixels_around(np.asarray(jc.center), 4000, 680.0, 1)
    depth = np.random.default_rng(2).uniform(0.2, 3.0, 4000).astype(
        np.float32)
    want = np.asarray(jfe.camera2world(jc, jnp.asarray(px),
                                       jnp.asarray(depth)))
    got = tfe.camera2world(tc, t(px), t(depth)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-6, atol=2e-6)
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), depth,
                               rtol=1e-5)


def test_world2camera_with_depth_matches_jax():
    cam = tfe.default_camera("egosyn")
    p3d = (np.random.default_rng(3).normal(size=(4, 15, 3))
           + np.array([0, 0, 1.5])).astype(np.float32)
    w2, wd = jfe.world2camera_with_depth(jfe.default_camera("egosyn"),
                                         jnp.asarray(p3d))
    g2, gd = tfe.world2camera_with_depth(cam, t(p3d))
    np.testing.assert_allclose(g2.numpy(), np.asarray(w2), rtol=1e-5,
                               atol=1e-3)
    np.testing.assert_allclose(gd.numpy(), np.asarray(wd), rtol=1e-6)


def test_undistort_matches_jax():
    """Within 400 px of the centre: nearer the image circle the
    unit-depth ray's z goes to 0 and the pinhole image to infinity."""
    jc, tc = jfe.default_camera("egosyn"), tfe.default_camera("egosyn")
    px = pixels_around(np.asarray(jc.center), 500, 400.0, 4)
    want = np.asarray(jfe.undistort(jc, jnp.asarray(px)))
    got = tfe.undistort(tc, t(px)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(tfe.undistort(tc, t(px), focal=300.0),
                               np.asarray(jfe.undistort(
                                   jc, jnp.asarray(px), focal=300.0)),
                               rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("kw", [{}, dict(focal_length_mm=8.0,
                                         sensor_size_mm=30.0,
                                         img_size=(1024, 1024))])
def test_equisolid_matches_jax(kw):
    """The parameters, and the unprojection inside and past the rim clamp
    (max_radius - 30)."""
    jc, tc = jfe.equisolid(**kw), tfe.equisolid(**kw)
    for a, b in ((jc.focal_px, tc.focal_px), (jc.center, tc.center),
                 (jc.max_radius, tc.max_radius)):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    px = pixels_around(np.asarray(jc.center), 1000,
                       float(jc.max_radius) + 40.0, 5)
    depth = np.full(1000, 5.0, np.float32)
    want = np.asarray(jfe.equisolid_camera2world(jc, jnp.asarray(px),
                                                 jnp.asarray(depth)))
    got = tfe.equisolid_camera2world(tc, t(px), t(depth)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # past the clamp the ray is lateral (theta = 90 degrees)
    rim = tfe.equisolid_camera2world(
        tc, t([[640.0 + 500.0, 512.0]]), t([5.0])).numpy()
    assert abs(rim[0, 2]) < 1e-3 * abs(rim[0, 0])


# ---------------------------------------------------------------------------
# transforms
# ---------------------------------------------------------------------------

def test_rotmat_to_quat_matches_jax_up_to_sign():
    """Random rotations and the pivots' edge cases (identity, half turns
    about each axis and a diagonal), held to JAX up to the double cover,
    and round-tripped through quat_to_rotmat on JAX's test's rotations."""
    R = Rotation.random(64, random_state=7).as_matrix()
    special = Rotation.from_rotvec(np.pi * np.array([
        [0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1],
        [1 / np.sqrt(2), 1 / np.sqrt(2), 0]]) + 0.0).as_matrix()
    R = np.concatenate([R, special]).astype(np.float32)
    want = np.asarray(jtr.rotmat_to_quat(jnp.asarray(R)))
    got = ttr.rotmat_to_quat(t(R)).numpy()
    sign = np.where(np.sum(got * want, axis=-1) < 0, -1.0, 1.0)[:, None]
    np.testing.assert_allclose(got * sign, want, atol=1e-6)
    # JAX's round trip (tests/test_ops_geometry.py), its data and 1e-5
    R = Rotation.random(20, random_state=3).as_matrix()
    np.testing.assert_allclose(
        ttr.quat_to_rotmat(ttr.rotmat_to_quat(t(R))).numpy(), R, atol=1e-5)


# ---------------------------------------------------------------------------
# Umeyama variants
# ---------------------------------------------------------------------------

def test_umeyama_scale_only_and_no_centering_match_jax():
    rng = np.random.default_rng(8)
    P = rng.normal(size=(4, 30, 3)).astype(np.float32)
    R = Rotation.random(4, random_state=9).as_matrix()
    Q = (np.einsum("bni,bij->bnj", P, R) * 1.7 + rng.normal(
        scale=0.05, size=P.shape) + 0.3).astype(np.float32)
    np.testing.assert_allclose(
        tum.umeyama_scale_only(t(P), t(Q)).numpy(),
        np.asarray(jum.umeyama_scale_only(jnp.asarray(P), jnp.asarray(Q))),
        rtol=1e-4, atol=1e-5)
    want = jum.umeyama_no_centering(jnp.asarray(P), jnp.asarray(Q))
    got = tum.umeyama_no_centering(t(P), t(Q))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-5)


def outlier_data():
    """tests/test_umeyama_variants.py's data: 60 correspondences of a
    similarity (c = 2.2), a fifth of them thrown off by N(0, 5)."""
    rng = np.random.default_rng(0)
    n = 60
    P = rng.normal(size=(n, 3))
    R_true = Rotation.random(random_state=2).as_matrix()
    c_true, t_true = 2.2, np.array([0.5, -0.2, 1.0])
    Q = P @ R_true * c_true + t_true
    bad = rng.choice(n, size=n // 5, replace=False)
    Q[bad] += rng.normal(scale=5.0, size=(len(bad), 3))
    return (P.astype(np.float32), Q.astype(np.float32), R_true, c_true,
            t_true)


@pytest.mark.parametrize("seed,eps", [(0, 0.2), (3, 0.5)])
def test_ransac_fit_on_jax_indices(seed, eps):
    """The port's hypotheses are the index sets JAX's `umeyama_ransac`
    draws (its threefry draw, repeated here), exactly; the fit from them
    and the port's whole `umeyama_ransac` from the same seed against
    JAX's whole `umeyama_ransac`."""
    P, Q, *_ = outlier_data()
    n_iters, s = 40, 4
    idx = jax.vmap(lambda k: jax.random.choice(
        k, P.shape[0], (s,), replace=False))(
        jax.random.split(jax.random.PRNGKey(seed), n_iters))
    mine = tum.ransac_hypotheses(P.shape[0], n_iters, s, seed)
    np.testing.assert_array_equal(mine.numpy(), np.asarray(idx))
    want = jum.umeyama_ransac(jnp.asarray(P), jnp.asarray(Q), epsilon=eps,
                              n_iters=n_iters, sample_size=s, seed=seed)
    for got in (tum._ransac_fit(t(P), t(Q), mine, eps),
                tum.umeyama_ransac(t(P), t(Q), epsilon=eps, n_iters=n_iters,
                                   sample_size=s, seed=seed)):
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                       atol=1e-5)


def test_umeyama_ransac_rejects_outliers_as_jax():
    """The public function at its defaults (JAX's draws from seed 0)
    meets JAX's fit and the truth (JAX's test's tolerances)."""
    P, Q, R_true, c_true, t_true = outlier_data()
    c, R, tt = tum.umeyama_ransac(t(P), t(Q), epsilon=0.2, n_iters=80)
    np.testing.assert_allclose(float(c), c_true, rtol=1e-2)
    np.testing.assert_allclose(R.numpy(), R_true, atol=2e-2)
    np.testing.assert_allclose(tt.numpy(), t_true, atol=5e-2)
    want = jum.umeyama_ransac(jnp.asarray(P), jnp.asarray(Q), epsilon=0.2,
                              n_iters=80)
    for g, w in zip((c, R, tt), want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-5)
    c0, _, _ = tum.umeyama(t(P), t(Q))
    assert abs(float(c) - c_true) < abs(float(c0) - c_true)
    # the draw is the seed's: the same seed gives the same fit
    again = tum.umeyama_ransac(t(P), t(Q), epsilon=0.2, n_iters=80)
    assert float(again[0]) == float(c)


# ---------------------------------------------------------------------------
# epipolar geometry
# ---------------------------------------------------------------------------

def two_view(n=40, seed=10):
    """tests/test_aux.py's two-view scene: points 4 m ahead, camera 2 at
    [R|t], |t| = 1; unit rays in both cameras."""
    rng = np.random.default_rng(seed)
    X = rng.uniform(-1, 1, size=(n, 3)) + np.array([0, 0, 4.0])
    R = Rotation.from_euler("xyz", [5, -8, 3], degrees=True).as_matrix()
    tt = np.array([1.0, 0.2, -0.1])
    tt = tt / np.linalg.norm(tt)
    x2 = X @ R.T + tt
    r1 = X / np.linalg.norm(X, axis=1, keepdims=True)
    r2 = x2 / np.linalg.norm(x2, axis=1, keepdims=True)
    return (r1.astype(np.float32), r2.astype(np.float32), R, tt, X)


def test_pixels_to_rays_matches_jax():
    jc, tc = jfe.default_camera("egosyn"), tfe.default_camera("egosyn")
    px = pixels_around(np.asarray(jc.center), 300, 600.0, 11)
    want = np.asarray(jep.pixels_to_rays(jc, jnp.asarray(px)))
    np.testing.assert_allclose(tep.pixels_to_rays(tc, t(px)).numpy(), want,
                               atol=1e-6)
    K = np.array([[800.0, 0, 640.0], [0, 800.0, 360.0], [0, 0, 1.0]],
                 np.float32)
    want = np.asarray(jep.pinhole_pixels_to_rays(jnp.asarray(K),
                                                 jnp.asarray(px)))
    np.testing.assert_allclose(
        tep.pinhole_pixels_to_rays(t(K), t(px)).numpy(), want, atol=1e-6)


def test_essential_and_its_decomposition_match_jax():
    """E up to its sign; the four candidates as a set (the SVD's sign
    choices permute them), each decomposed from JAX's own E."""
    r1, r2, *_ = two_view()
    Ej = np.asarray(jep.essential_from_rays(jnp.asarray(r1),
                                            jnp.asarray(r2)))
    E = tep.essential_from_rays(t(r1), t(r2)).numpy()
    assert min(np.abs(E - Ej).max(), np.abs(E + Ej).max()) < 1e-4
    want = [(np.asarray(R), np.asarray(tt))
            for R, tt in jep.decompose_essential(jnp.asarray(Ej))]
    got = [(R.numpy(), tt.numpy())
           for R, tt in tep.decompose_essential(t(Ej))]
    for R, tt in got:
        np.testing.assert_allclose(np.linalg.det(R), 1.0, atol=1e-5)
        assert min(np.abs(R - Rw).max() + np.abs(tt - tw).max()
                   for Rw, tw in want) < 1e-4


def test_triangulation_and_cheirality_match_jax():
    r1, r2, R, tt, X = two_view()
    for Rc, tc in ((R, tt), (R, -tt), (R.T, tt)):
        args = (r1, r2, Rc.astype(np.float32), tc.astype(np.float32))
        want = jep.triangulate_midpoint(*map(jnp.asarray, args))
        got = tep.triangulate_midpoint(*map(t, args))
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)
        assert int(tep.cheirality_score(*map(t, args))) == int(
            jep.cheirality_score(*map(jnp.asarray, args)))


def test_recover_pose_matches_jax():
    """R, t and the points after cheirality, against JAX and the truth
    (tests/test_aux.py's tolerances)."""
    r1, r2, R_true, t_true, X = two_view()
    R, tt, pts = tep.recover_pose(t(r1), t(r2))
    Rj, tj, pj = jep.recover_pose(jnp.asarray(r1), jnp.asarray(r2))
    np.testing.assert_allclose(R.numpy(), np.asarray(Rj), atol=1e-4)
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), atol=1e-4)
    np.testing.assert_allclose(pts.numpy(), np.asarray(pj), atol=1e-3)
    np.testing.assert_allclose(R.numpy(), R_true, atol=1e-3)
    np.testing.assert_allclose(tt.numpy(), t_true, atol=1e-3)
    np.testing.assert_allclose(pts.numpy(), X, atol=1e-2)


def test_recover_pose_fisheye_pinhole_matches_jax():
    rng = np.random.default_rng(12)
    jc, tc = jfe.default_camera("egosyn"), tfe.default_camera("egosyn")
    X = (rng.uniform(-0.6, 0.6, size=(40, 3))
         + np.array([0, 0, 2.5])).astype(np.float32)
    px_fish = np.asarray(jfe.world2camera(jc, jnp.asarray(X)))
    R = Rotation.from_euler("xyz", [4, -6, 2], degrees=True).as_matrix()
    tt = np.array([0.8, 0.3, -0.2])
    tt = tt / np.linalg.norm(tt)
    K = np.array([[800.0, 0, 640.0], [0, 800.0, 360.0], [0, 0, 1.0]])
    x2 = X @ R.T + tt
    px_pin = (x2 @ K.T)
    px_pin = (px_pin[:, :2] / px_pin[:, 2:]).astype(np.float32)
    got = tep.recover_pose_fisheye_pinhole(tc, t(px_fish), K, t(px_pin))
    want = jep.recover_pose_fisheye_pinhole(
        jc, jnp.asarray(px_fish), jnp.asarray(K, jnp.float32),
        jnp.asarray(px_pin))
    for g, w, tol in zip(got, want, (1e-4, 1e-4, 1e-3)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=tol)
    np.testing.assert_allclose(got[0].numpy(), R, atol=5e-3)
    np.testing.assert_allclose(got[1].numpy(), tt, atol=5e-3)
    np.testing.assert_allclose(got[2].numpy(), X, atol=5e-2)
