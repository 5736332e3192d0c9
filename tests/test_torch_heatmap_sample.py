"""The port's heatmap sampler (`ops/heatmap_sample.py`, plain version on
the CPU) against the JAX package's `heatmap_sample_pallas` run in
interpret mode: forward and point gradient on the same numpy inputs,
with the tolerances of tests/test_pallas_kernels.py (forward rtol 1e-4 /
atol 1e-5, gradient rtol 1e-3 / atol 1e-4).  The points include ones
outside [-1, 1] and ones on exact integer pixel coordinates, where the
TPU backward's kink convention gives a zero derivative along that axis."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from globalegomocap_tpu.ops.pallas.heatmap_sample import (
    heatmap_sample_pallas)
from globalegomocap_tpu_torch.ops import cuda_build
from globalegomocap_tpu_torch.ops import heatmap_sample as ths
from globalegomocap_tpu_torch.ops.sampling import grid_sample_bilinear

N = 300


def _inputs(size, seed, r=1):
    """maps (N, size, size), points (r, N, 2): uniform in [-1.3, 1.3], the
    first 40 of each row on exact pixel coordinates (integers, cells
    k/(size-1) apart, exact in float32 when size - 1 is a power of 2, and
    the corners +-1 for any size)."""
    rng = np.random.default_rng(seed)
    maps = rng.random((N, size, size)).astype(np.float32)
    pts = rng.uniform(-1.3, 1.3, size=(r, N, 2)).astype(np.float32)
    cells = rng.integers(0, size, size=(r, 40, 2))
    pts[:, :40] = (2.0 * cells / (size - 1) - 1.0).astype(np.float32)
    pts[:, 40:44] = np.array([[-1, -1], [1, 1], [-1, 1], [1, -1]],
                             np.float32)
    return maps, pts


def _jax(maps, pts, ct, bf16):
    """Forward and d(sum ct * sample)/dpoints of the interpret-mode
    kernel, one probe row at a time."""
    jm = jnp.asarray(maps)
    if bf16:
        jm = jm.astype(jnp.bfloat16)
    outs, grads = [], []
    for r in range(pts.shape[0]):
        p, c = jnp.asarray(pts[r]), jnp.asarray(ct[r])
        outs.append(np.asarray(heatmap_sample_pallas(jm, p)))
        grads.append(np.asarray(jax.grad(
            lambda q: jnp.sum(heatmap_sample_pallas(jm, q) * c))(p)))
    return np.stack(outs), np.stack(grads)


@pytest.mark.parametrize("size", [64, 65])
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("r", [1, 2])
def test_plain_version_matches_pallas_kernel(size, bf16, r):
    maps, pts = _inputs(size, seed=size + r, r=r)
    ct = np.random.default_rng(3).normal(size=(r, N)).astype(np.float32)
    jout, jgrad = _jax(maps, pts, ct, bf16)
    tm = torch.from_numpy(maps)
    if bf16:
        tm = tm.to(torch.bfloat16)
    tp = torch.from_numpy(pts).requires_grad_(True)
    out = ths.heatmap_sample(tm, tp)
    (grad,) = torch.autograd.grad(out, tp, grad_outputs=torch.from_numpy(ct))
    np.testing.assert_allclose(out.detach().numpy(), jout, rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(grad.numpy(), jgrad, rtol=1e-3, atol=1e-4)


def test_kink_convention_at_integer_coordinates():
    """On an exact integer pixel coordinate the derivative along that axis
    is 0 (the TPU backward's -sign(0) = 0), not a one-sided difference."""
    size = 65
    maps = np.zeros((1, size, size), np.float32)
    maps[0] = np.arange(size, dtype=np.float32)[None, :] * 2.0   # ramp in x
    pts = np.array([[[0.5, 0.25]]], np.float32)       # ix = 48, iy = 40
    g = ths.heatmap_sample_bwd(torch.from_numpy(maps), torch.from_numpy(pts),
                               torch.ones((1, 1)))
    assert g[0, 0, 0].item() == 0.0
    pts_off = pts + np.float32(1.0 / 64 / 4)            # quarter cell off
    g = ths.heatmap_sample_bwd(torch.from_numpy(maps),
                               torch.from_numpy(pts_off), torch.ones((1, 1)))
    np.testing.assert_allclose(g[0, 0, 0].item(), 2.0 * 32.0, rtol=1e-6)


def test_plain_version_matches_gather_sampling_and_grid_sample():
    """The dense plain version, the port's 4-tap gather and the library
    twin F.grid_sample agree on the values (away from the kinks the
    derivatives agree too)."""
    maps, pts = _inputs(64, seed=9, r=2)
    tm, tp = torch.from_numpy(maps), torch.from_numpy(pts)
    dense = ths.plain_forward(tm, tp)
    gather = grid_sample_bilinear(tm, tp)
    lib = torch.nn.functional.grid_sample(
        tm[:, None], tp.permute(1, 0, 2)[:, None], mode="bilinear",
        padding_mode="zeros", align_corners=True)[:, 0, 0].T
    np.testing.assert_allclose(dense.numpy(), gather.numpy(), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(dense.numpy(), lib.numpy(), rtol=1e-5,
                               atol=1e-6)


def test_cpu_tensors_run_the_plain_version_and_count_no_launch():
    maps, pts = _inputs(64, seed=4)
    cuda_build.reset_launches()
    out = ths.heatmap_sample_fwd(torch.from_numpy(maps),
                                 torch.from_numpy(pts))
    np.testing.assert_array_equal(
        out.numpy(), ths.plain_forward(torch.from_numpy(maps),
                                       torch.from_numpy(pts)).numpy())
    assert cuda_build.LAUNCHES["heatmap_sample"] == 0


def test_wrapper_rejects_bad_arguments():
    maps, pts = _inputs(64, seed=5)
    tm, tp = torch.from_numpy(maps), torch.from_numpy(pts)
    with pytest.raises(ValueError, match="points must be"):
        ths.heatmap_sample_fwd(tm, tp[:, :10])
    with pytest.raises(TypeError, match="dtype"):
        ths.heatmap_sample_fwd(tm.half(), tp)
    with pytest.raises(TypeError, match="dtype"):
        ths.heatmap_sample_fwd(tm, tp.double())
    with pytest.raises(ValueError, match="contiguous"):
        ths.heatmap_sample_fwd(tm.transpose(1, 2).contiguous().transpose(
            1, 2), tp)
    with pytest.raises(ValueError, match="shape"):
        ths.heatmap_sample_bwd(tm, tp, torch.ones((1, N - 1)))
