"""The port's fused stage energies (globalegomocap_tpu_torch/ops/
fused_energy.py) against the JAX Pallas kernels (interpret mode on the
CPU): on CPU tensors the wrappers run the plain PyTorch version, which
must match the TPU kernel's value and gradient."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from globalegomocap_tpu.ops import fisheye as jfisheye
from globalegomocap_tpu.ops.pallas import fused_energy as jfe
from globalegomocap_tpu_torch.ops import fused_energy as tfe

T, J = 10, 15
L = T * J
FULL_HW = (64, 64)
# camera centre + W2C polynomial of the built-in 'egosyn' rig
_CAM = jfisheye.default_camera("egosyn")
WVEC = np.array([[0.01, 0.001, 0.02, 0.003, 0.01,
                  float(_CAM.center[0]), float(_CAM.center[1]), 0.0]],
                np.float32)
POLY = np.asarray(_CAM.poly_w2c, np.float32)[None]


def _inputs(r, b, k, seed):
    """Kernel-layout inputs made with numpy: poses near the synthetic
    skeleton's depth, and each window's crop origins around the first
    probe's projection (+-1 cell), so the k x k cells sample real
    weights."""
    rng = np.random.default_rng(seed)
    pose = (rng.normal(scale=0.3, size=(r, b, T, J, 3))
            + np.array([0, 0, 1.5])).astype(np.float32)
    anchor = (pose[0] + rng.normal(scale=0.05, size=pose.shape[1:])
              ).astype(np.float32)
    crops = rng.uniform(size=(b, k * k, L)).astype(np.float32)
    pose_rt = np.ascontiguousarray(
        np.moveaxis(pose.reshape(r, b, L, 3), -1, 2))
    p0 = torch.from_numpy(pose_rt[0])
    ix0, iy0, _ = tfe.crop_coordinates(p0[:, 0], p0[:, 1], p0[:, 2],
                                       _t(WVEC), _t(POLY), 63 / 1024,
                                       63 / 1024, 128.0)
    ox = (np.floor(ix0.numpy()) - k // 2
          + rng.integers(-1, 2, size=(b, L))).astype(np.float32)
    oy = (np.floor(iy0.numpy()) - k // 2
          + rng.integers(-1, 2, size=(b, L))).astype(np.float32)
    bone = np.tile(rng.uniform(0.1, 0.5, size=(b, J)), (1, T)).astype(
        np.float32)
    anchor_t = np.ascontiguousarray(np.moveaxis(anchor.reshape(b, L, 3),
                                                -1, 1))
    return pose_rt, anchor_t, crops, ox, oy, bone


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _bf16_pair(crops):
    """The same bf16-rounded crops for both packages."""
    c16 = torch.from_numpy(crops).to(torch.bfloat16)
    return c16, jnp.asarray(c16.to(torch.float32).numpy(), jnp.bfloat16)


@pytest.mark.parametrize("k,bf16", [(8, True), (16, True), (8, False)])
@pytest.mark.parametrize("r", [1, 2])
def test_stage_energy_matches_jax(k, bf16, r):
    """The serve path stages bf16 crops at k=8 and, on a guard trip, at
    k=16; f32 crops are the heatmap_dtype="float32" path."""
    b = 7
    pose_rt, anchor_t, crops, ox, oy, bone = _inputs(r, b, k, seed=k + r)
    if bf16:
        c_t, c_j = _bf16_pair(crops)
    else:
        c_t, c_j = _t(crops), jnp.asarray(crops)
    e_j, g_j = jfe._energy_and_grad(
        jnp.asarray(pose_rt), jnp.asarray(anchor_t), c_j, jnp.asarray(ox),
        jnp.asarray(oy), jnp.asarray(bone), jnp.asarray(WVEC),
        jnp.asarray(POLY), T, J, k, FULL_HW, 128.0, 512.0)
    e_t, g_t = tfe.stage_energy_and_grad(
        _t(pose_rt), _t(anchor_t), c_t, _t(ox), _t(oy), _t(bone),
        _t(WVEC), _t(POLY), T, J, k, FULL_HW, 128.0, 512.0)
    np.testing.assert_allclose(e_t.numpy(), np.asarray(e_j),
                               rtol=2e-5, atol=1e-5)
    np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j),
                               rtol=2e-5, atol=1e-5)
    if k != 8:
        return
    # the custom-VJP entry point gives the same value
    e_vjp = jfe.fused_stage_energy(
        jnp.asarray(pose_rt), jnp.asarray(anchor_t), c_j, jnp.asarray(ox),
        jnp.asarray(oy), jnp.asarray(bone),
        (jnp.asarray(WVEC), jnp.asarray(POLY)), T, J, k, FULL_HW, 128.0,
        512.0)
    e_w = tfe.fused_stage_energy(
        _t(pose_rt), _t(anchor_t), c_t, _t(ox), _t(oy), _t(bone),
        (_t(WVEC), _t(POLY)), T, J, k, FULL_HW, 128.0, 512.0)
    np.testing.assert_allclose(e_w.numpy(), np.asarray(e_vjp),
                               rtol=2e-5, atol=1e-5)


@pytest.mark.parametrize("r", [1, 2])
def test_noreproj_energy_matches_jax(r):
    b = 7
    pose_rt, anchor_t, _, _, _, bone = _inputs(r, b, 8, seed=30 + r)
    wvec = WVEC.copy()
    wvec[0, :5] = [1.0, 0.001, 0.01, 0.002, 0.0]
    e_j, g_j = jfe._energy_and_grad_noreproj(
        jnp.asarray(pose_rt), jnp.asarray(anchor_t), jnp.asarray(bone),
        jnp.asarray(wvec), T, J)
    e_t, g_t = tfe.stage_energy_and_grad_noreproj(
        _t(pose_rt), _t(anchor_t), _t(bone), _t(wvec), T, J)
    np.testing.assert_allclose(e_t.numpy(), np.asarray(e_j),
                               rtol=2e-5, atol=1e-5)
    np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j),
                               rtol=2e-5, atol=1e-5)
    e_vjp = jfe.fused_stage_energy_noreproj(
        jnp.asarray(pose_rt), jnp.asarray(anchor_t), jnp.asarray(bone),
        jnp.asarray(wvec), T, J)
    e_w = tfe.fused_stage_energy_noreproj(_t(pose_rt), _t(anchor_t),
                                          _t(bone), _t(wvec), T, J)
    np.testing.assert_allclose(e_w.numpy(), np.asarray(e_vjp),
                               rtol=2e-5, atol=1e-5)


@pytest.mark.parametrize("with_reproj", [True, False])
def test_plain_grad_matches_autograd(with_reproj):
    """The hand-written gradient equals autograd of the plain energy
    (float64, at random points: the triangle kernel's kinks have measure
    zero)."""
    k = 8
    pose_rt, anchor_t, crops, ox, oy, bone = _inputs(2, 5, k, seed=11)
    d = lambda x: _t(x).double()  # noqa: E731
    pose = d(pose_rt).requires_grad_(True)
    args = (d(anchor_t), d(crops), d(ox), d(oy), d(bone), d(WVEC), d(POLY),
            T, J, k, 63 / 1024, 63 / 1024, 128.0)
    e, g = tfe.plain_energy_and_grad(pose, *args, with_reproj=with_reproj)
    (g_auto,) = torch.autograd.grad(e.sum(), pose)
    np.testing.assert_allclose(g.detach().numpy(), g_auto.numpy(),
                               rtol=1e-9, atol=1e-12)


def test_cell_centre_has_zero_derivative():
    """A projection exactly on a cell centre: the triangle kernel's a.e.
    derivative there is 0 (not the +-1 copysign would give), so with only
    the reprojection term on, that point's gradient is exactly zero and
    its energy is minus the centre cell's value."""
    k = 8
    pose_rt, anchor_t, crops, _, _, bone = _inputs(1, 1, k, seed=12)
    pose_rt[0, 0, :, 0] = [0.3, -0.2, 1.5]
    wvec = WVEC.copy()
    wvec[0, :5] = [0.0, 0.0, 0.0, 0.0, 1.0]
    p = _t(pose_rt)
    sx = sy = 63 / 1024
    ix0, iy0, _ = tfe.crop_coordinates(p[:, :, 0], p[:, :, 1], p[:, :, 2],
                                       _t(wvec), _t(POLY), sx, sy, 128.0)
    # point 0 lands exactly on cell (3, 5) (Sterbenz: |ix0| >= 6); the
    # other points sit a quarter cell off their centres
    ox = (ix0[0] - 3.0).numpy()
    oy = (iy0[0] - 5.0).numpy()
    ox[:, 1:] -= 0.25
    oy[:, 1:] -= 0.25
    assert float(ix0[0, 0, 0] - float(ox[0, 0])) == 3.0
    assert float(iy0[0, 0, 0] - float(oy[0, 0])) == 5.0
    e, g = tfe.stage_energy_and_grad(
        p, _t(anchor_t), _t(crops), _t(ox), _t(oy), _t(bone), _t(wvec),
        _t(POLY), T, J, k, FULL_HW, 128.0, 512.0)
    assert g[0, 0, :, 0].abs().max().item() == 0.0
    # the other points still carry gradient
    assert g[0, 0].abs().sum().item() > 0.0
    e_point = -crops[0, 5 * k + 3, 0]
    e_rest, _ = tfe.stage_energy_and_grad(
        p, _t(anchor_t), _t(crops * (np.arange(L) > 0)), _t(ox), _t(oy),
        _t(bone), _t(wvec), _t(POLY), T, J, k, FULL_HW, 128.0, 512.0)
    # a difference of two float32 row sums of ~150 terms of order 0.5:
    # each sum rounds at ~4e-6
    np.testing.assert_allclose(float(e[0, 0] - e_rest[0, 0]), e_point,
                               rtol=0, atol=2e-5)


@pytest.mark.parametrize("noreproj", [False, True])
def test_autograd_function_backward(noreproj):
    """backward = ct[..., None, None] * g, the JAX custom VJP."""
    k = 8
    pose_rt, anchor_t, crops, ox, oy, bone = _inputs(2, 4, k, seed=13)
    ct = np.random.default_rng(14).normal(size=(2, 4)).astype(np.float32)
    pose = _t(pose_rt).requires_grad_(True)
    if noreproj:
        e = tfe.fused_stage_energy_noreproj(pose, _t(anchor_t), _t(bone),
                                            _t(WVEC), T, J)
        _, g = tfe.stage_energy_and_grad_noreproj(
            _t(pose_rt), _t(anchor_t), _t(bone), _t(WVEC), T, J)
    else:
        ctx = (_t(WVEC), _t(POLY))
        e = tfe.fused_stage_energy(pose, _t(anchor_t), _t(crops), _t(ox),
                                   _t(oy), _t(bone), ctx, T, J, k, FULL_HW,
                                   128.0, 512.0)
        _, g = tfe.stage_energy_and_grad(
            _t(pose_rt), _t(anchor_t), _t(crops), _t(ox), _t(oy), _t(bone),
            *ctx, T, J, k, FULL_HW, 128.0, 512.0)
    (g_pose,) = torch.autograd.grad(e, pose, grad_outputs=_t(ct))
    np.testing.assert_array_equal(g_pose.numpy(),
                                  (_t(ct)[:, :, None, None] * g).numpy())


def test_wrapper_rejects_bad_arguments():
    pose_rt, anchor_t, crops, ox, oy, bone = _inputs(1, 3, 8, seed=15)
    args = [_t(pose_rt), _t(anchor_t), _t(crops), _t(ox), _t(oy), _t(bone),
            _t(WVEC), _t(POLY), T, J, 8, FULL_HW, 128.0, 512.0]
    tfe.stage_energy_and_grad(*args)
    bad = list(args)
    bad[1] = _t(anchor_t).double()
    with pytest.raises(TypeError):
        tfe.stage_energy_and_grad(*bad)
    bad = list(args)
    bad[2] = _t(crops)[:, :32]
    with pytest.raises(ValueError):
        tfe.stage_energy_and_grad(*bad)
    bad = list(args)
    bad[0] = _t(pose_rt).transpose(2, 3).contiguous().transpose(2, 3)
    with pytest.raises(ValueError):
        tfe.stage_energy_and_grad(*bad)


def _tap_sample(ix, iy, crops, k):
    """PyTorch transcription of the kernel's 2 x 2-tap sampling
    (csrc/taps.cuh and the reprojection of csrc/energy_core.cuh's
    energy_row), float32: (s, ds/dix, ds/diy) for ix, iy (B, L) and crops
    (B, k*k, L)."""
    zero = torch.zeros((), dtype=ix.dtype)

    def axis(i):
        f0 = torch.floor(i)
        f1 = f0 + 1.0
        in0 = (f0 >= 0.0) & (f0 <= k - 1.0)
        in1 = (f1 >= 0.0) & (f1 <= k - 1.0)
        # an int only after the range test: NaN and +-1e30 read nothing
        c0 = torch.where(in0 | in1, f0, zero).to(torch.int64)
        return c0, (in0, in1), (i - f0, i - f1)

    def tri(a):                       # fmaxf(0, 1 - |a|): NaN gives 0
        w = 1.0 - a.abs()
        return torch.where(w > 0.0, w, zero)

    def tri_grad(a):
        inner = torch.where(a > 0.0, -1.0, torch.where(a < 0.0, 1.0, 0.0))
        return torch.where(a.abs() < 1.0, inner, zero)

    cx0, inx, ax = axis(ix)
    cy0, iny, ay = axis(iy)

    def tap(row1, col1):
        inside = iny[row1] & inx[col1]
        cell = torch.where(inside, (cy0 + row1) * k + cx0 + col1, 0)
        v = torch.gather(crops, 1, cell[:, None, :])[:, 0]
        return torch.where(inside, v, zero)

    s, dix, diy = (torch.zeros_like(ix) for _ in range(3))
    # the dense loop's order: row c0 before c0 + 1, column c0 before c0 + 1
    for row1 in (0, 1):
        for col1 in (0, 1):
            c = tap(row1, col1)
            wx, wy = tri(ax[col1]), tri(ay[row1])
            dwx, dwy = tri_grad(ax[col1]), tri_grad(ay[row1])
            s = s + c * wx * wy
            dix = dix + c * dwx * wy
            diy = diy + c * wx * dwy
    return s, dix, diy


def _tap_coordinates(k, rng, b):
    """(ix, iy) (b, L): random coordinates around and beyond the crop, and
    on each axis the special places: exact integer cells (0 and k - 1
    among them), half cells at both edges, just outside and far outside on
    each side, NaN and +-1e30."""
    special = np.array(
        [0.0, k - 1.0, 1.0, k / 2, -0.5, k - 0.5, -1.0, float(k),
         np.nextafter(np.float32(0), np.float32(-1)),
         np.nextafter(np.float32(k - 1), np.float32(k)), -1.5, k + 0.5,
         -7.0, k + 7.0, np.nan, 1e30, -1e30], np.float32)
    n = b * L
    ix = rng.uniform(-3.0, k + 2.0, n).astype(np.float32)
    iy = rng.uniform(-3.0, k + 2.0, n).astype(np.float32)
    m = len(special)
    ix[:m * m] = np.repeat(special, m)          # every pair of specials
    iy[:m * m] = np.tile(special, m)
    ix[m * m:m * m + 40] = rng.integers(0, k, 40)   # integer on both axes
    iy[m * m:m * m + 40] = rng.integers(0, k, 40)
    perm = rng.permutation(n)
    return (torch.from_numpy(ix[perm].reshape(b, L)),
            torch.from_numpy(iy[perm].reshape(b, L)))


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("k", [8, 16, 24])
def test_tap_sampling_equals_dense_cells(k, bf16):
    """The kernel's 2 x 2 taps give the plain version's dense k*k cell
    sum: bit for bit against the dense terms (`dense_cell_terms`) added in
    the dense loop's cell order, and within the reassociation of four
    float32 terms against `plain_energy_and_grad`'s `.sum` over the cells
    (PyTorch sums the cells in blocks, so the four non-zero terms may pair
    differently: at most 3 float32 eps of the sum of their magnitudes).
    Both comparisons hold where neither coordinate is NaN: there the plain
    version's clamp keeps the NaN (as JAX's jnp.maximum does), while the
    taps read nothing and give 0 (the kernel's fmaxf drops a NaN), which
    is checked on its own."""
    rng = np.random.default_rng(40 + k + bf16)
    b = 3
    ix, iy = _tap_coordinates(k, rng, b)
    crops = torch.from_numpy(rng.uniform(size=(b, k * k, L)).astype(
        np.float32))
    if bf16:
        crops = crops.to(torch.bfloat16).to(torch.float32)
    taps = _tap_sample(ix, iy, crops, k)
    terms = tfe.dense_cell_terms(ix, iy, crops, k)
    nan = torch.isnan(ix) | torch.isnan(iy)
    assert nan.any() and not bool(nan.all())
    eps = torch.finfo(torch.float32).eps
    for got, t in zip(taps, terms):
        ordered = torch.zeros_like(ix)
        for cell in range(k * k):
            ordered = ordered + t[:, cell]
        assert torch.equal(got[~nan].view(torch.int32),
                           ordered[~nan].view(torch.int32))
        bound = 3 * eps * t.abs().sum(1)
        assert bool(((got - t.sum(1)).abs() <= bound)[~nan].all())
        assert bool((got[nan] == 0).all())
    # the specials landed: NaN and +-1e30 read nothing, and some points
    # sample a crop edge with one tap outside
    s = taps[0]
    assert bool(torch.isfinite(torch.stack(taps)).all())
    far = ~(ix.abs() < 1e29) | ~(iy.abs() < 1e29)         # NaN too
    assert far.any() and bool((s[far] == 0).all())
    edge = (ix == -0.5) & (iy >= 0) & (iy <= k - 1)
    assert edge.any() and bool((s[edge] > 0).all())
