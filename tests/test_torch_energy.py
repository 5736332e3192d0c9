"""The port's plain PyTorch stage energy (`energy/terms.py`) against the
JAX package's `total_energy_from_pose` under `vmap` over windows: value
and pose gradient on full maps with each `sampling_impl` (gather, dense,
and pallas, which is the heatmap_sample kernel's plain version here and
the interpret-mode Pallas kernel on the JAX side) and on k x k crops; and
the device-side crops of the per-chunk path, bit-exact against the numpy
staging and the JAX crops."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from globalegomocap_tpu.energy import terms as jt
from globalegomocap_tpu.ops import fisheye as jfish
from globalegomocap_tpu_torch.energy import terms as tt
from globalegomocap_tpu_torch.ops import fisheye as tfish
from tests.torch_port_helpers import chunks

W_KW = dict(weight_3d=1e-6, smooth=1e-5, bone_length=0.01, vae=1e-3,
            reproj=0.01)


@pytest.fixture(scope="module")
def windows():
    """Three windows of a synthetic chunk: noisy poses, anchors, bone
    lengths, full maps (W, T, J, H, W) and peak crops with origins."""
    c = chunks(26, seeds=(3,))[0]
    idx = np.arange(3)[:, None] * 8 + np.arange(10)[None, :]
    est = np.asarray(c.estimated_local)
    rng = np.random.default_rng(0)
    anchor = est[idx]
    pose = (anchor + 0.02 * rng.normal(size=anchor.shape)).astype(
        np.float32)
    bl = np.asarray(jt.bone_lengths(jnp.asarray(est))).mean(0)
    bl = np.broadcast_to(bl, (3, 15)).astype(np.float32)
    maps = np.moveaxis(np.asarray(c.heatmaps)[idx], -1, 2)
    crops, org, full_hw, _, _ = jt.crop_heatmaps_channels_last_np(
        np.asarray(c.heatmaps), 8)
    return dict(pose=pose, anchor=anchor, bl=bl, maps=maps,
                crops=np.moveaxis(crops[idx], -1, 2), org=org[idx],
                full_hw=full_hw, chunk=c)


def _jax_energy(win, impl, cropped):
    cam = jfish.default_camera("egosyn")
    w = jt.EnergyWeights.create(**W_KW)
    heat = win["crops"] if cropped else win["maps"]
    org = jnp.asarray(win["org"]) if cropped else None
    fh = win["full_hw"] if cropped else None

    def one(p, a, b, h, o):
        return jt.total_energy_from_pose(p, a, b, h, cam, w, True,
                                         sampling_impl=impl, origins=o,
                                         full_hw=fh)
    ax = 0 if cropped else None
    args = (jnp.asarray(win["pose"]), jnp.asarray(win["anchor"]),
            jnp.asarray(win["bl"]), jnp.asarray(heat), org)
    e = jax.vmap(one, in_axes=(0, 0, 0, 0, ax))(*args)
    g = jax.vmap(jax.grad(one), in_axes=(0, 0, 0, 0, ax))(*args)
    return np.asarray(e), np.asarray(g)


def _port_energy(win, impl, cropped, pose):
    cam = tfish.default_camera("egosyn")
    w = tt.EnergyWeights.create(**W_KW)
    heat = win["crops"] if cropped else win["maps"]
    org = torch.from_numpy(win["org"]) if cropped else None
    fh = win["full_hw"] if cropped else None
    p = torch.from_numpy(pose).requires_grad_(True)
    e = tt.total_energy_from_pose(
        p, torch.from_numpy(win["anchor"]), torch.from_numpy(win["bl"]),
        torch.from_numpy(np.ascontiguousarray(heat)), cam, w, True,
        sampling_impl=impl, origins=org, full_hw=fh)
    (g,) = torch.autograd.grad(e.sum(), p)
    return e.detach().numpy(), g.numpy()


# on crops, `pallas` samples with the gather (as in the JAX package)
CASES = [("gather", False), ("dense", False), ("pallas", False),
         ("gather", True), ("dense", True), ("pallas", True)]


@pytest.mark.parametrize("impl,cropped", CASES,
                         ids=[f"{i}-{'crops' if c else 'maps'}"
                              for i, c in CASES])
def test_total_energy_matches_jax(windows, impl, cropped):
    je, jg = _jax_energy(windows, impl, cropped)
    te, tg = _port_energy(windows, impl, cropped, windows["pose"])
    np.testing.assert_allclose(te, je, rtol=2e-5, atol=1e-5)
    np.testing.assert_allclose(tg, jg, rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("impl", ["gather", "dense", "pallas"])
def test_probe_axis_shares_the_window_context(windows, impl):
    """A leading probe axis (R, W, ...) gives each probe row's energy as
    if evaluated alone."""
    rng = np.random.default_rng(1)
    poses = (windows["pose"][None]
             + 0.01 * rng.normal(size=(2,) + windows["pose"].shape)
             ).astype(np.float32)
    e2, g2 = _port_energy(windows, impl, False, poses)
    for r in range(2):
        e1, g1 = _port_energy(windows, impl, False, poses[r])
        np.testing.assert_allclose(e2[r], e1, rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(g2[r], g1, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("k", [8, 16])
def test_device_crops_bit_exact(windows, k):
    c = windows["chunk"]
    heat = np.asarray(c.heatmaps)
    cr, org, hw = tt.crop_heatmaps_channels_last(torch.from_numpy(heat), k)
    ncr, norg, nhw, _, _ = tt.crop_heatmaps_channels_last_np(heat, k)
    jcr, jorg, _ = jt.crop_heatmaps_channels_last(jnp.asarray(heat), k)
    np.testing.assert_array_equal(cr.numpy(), ncr)
    np.testing.assert_array_equal(org.numpy(), norg)
    np.testing.assert_array_equal(cr.numpy(), np.asarray(jcr))
    np.testing.assert_array_equal(org.numpy(), np.asarray(jorg))
    assert hw == nhw

    est = torch.from_numpy(np.asarray(c.estimated_local))
    cen = tt.projected_estimate_centers(est, tfish.default_camera("egosyn"),
                                        64, 64)
    cr, org, _ = tt.crop_heatmaps_at_centers_channels_last(
        torch.from_numpy(heat), k, cen)
    ncr, norg, _ = tt.crop_heatmaps_at_centers_channels_last_np(
        heat, k, cen.numpy())
    jcr, jorg, _ = jt.crop_heatmaps_at_centers_channels_last(
        jnp.asarray(heat), k, jnp.asarray(cen.numpy()))
    np.testing.assert_array_equal(cr.numpy(), ncr)
    np.testing.assert_array_equal(org.numpy(), norg)
    np.testing.assert_array_equal(cr.numpy(), np.asarray(jcr))
    np.testing.assert_array_equal(org.numpy(), np.asarray(jorg))
