"""The port's heatmap sampler (`ops/heatmap_sample.py`, plain version on
the CPU) against the JAX package's `heatmap_sample_pallas` run in
interpret mode: forward and point gradient on the same numpy inputs,
with the tolerances of tests/test_pallas_kernels.py (forward rtol 1e-4 /
atol 1e-5, gradient rtol 1e-3 / atol 1e-4).  The points include ones
outside [-1, 1] and ones on exact integer pixel coordinates, where the
TPU backward's kink convention gives a zero derivative along that axis.
The backward runs on the forward's residual (the point partials dix,
diy): its plain form is held against JAX's `jax.vjp`, and a call with no
graph to record writes none."""

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


def _jax_maps(maps, bf16):
    jm = jnp.asarray(maps)
    return jm.astype(jnp.bfloat16) if bf16 else jm


def _jax(maps, pts, ct, bf16):
    """Forward and d(sum ct * sample)/dpoints of the interpret-mode
    kernel, one probe row at a time."""
    jm = _jax_maps(maps, bf16)
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


def _jax_vjp(maps, pts, ct, bf16):
    """JAX's `_bwd_rule` through `jax.vjp`, one probe row at a time: the
    forward and the point cotangent of `ct`."""
    jm = _jax_maps(maps, bf16)
    outs, grads = [], []
    for r in range(pts.shape[0]):
        out, vjp = jax.vjp(heatmap_sample_pallas, jm, jnp.asarray(pts[r]))
        outs.append(np.asarray(out))
        grads.append(np.asarray(vjp(jnp.asarray(ct[r]))[1]))
    return np.stack(outs), np.stack(grads)


@pytest.mark.parametrize("size", [64, 65])
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("r", [1, 2])
def test_residual_and_plain_backward_match_pallas_vjp(size, bf16, r):
    """The forward's residual form (samples and the partials dix, diy)
    and the backward over it against JAX's `jax.vjp`: the backward of a
    cotangent, and the residual scaled by (sx, sy) as the backward of a
    unit cotangent."""
    maps, pts = _inputs(size, seed=size + r + 20, r=r)
    ct = np.random.default_rng(5).normal(size=(r, N)).astype(np.float32)
    jout, jgrad = _jax_vjp(maps, pts, ct, bf16)
    _, junit = _jax_vjp(maps, pts, np.ones_like(ct), bf16)
    tm = torch.from_numpy(maps)
    if bf16:
        tm = tm.to(torch.bfloat16)
    out, res = ths.plain_forward(tm, torch.from_numpy(pts), residual=True)
    assert res.shape == (r, N, 2) and res.dtype == torch.float32
    grad = ths.plain_backward(res, torch.from_numpy(ct), (size, size))
    scale = torch.tensor([0.5 * (size - 1)] * 2)
    np.testing.assert_allclose(out.numpy(), jout, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(grad.numpy(), jgrad, rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose((res * scale).numpy(), junit, rtol=1e-3,
                               atol=1e-4)
    # the wrapper on CPU tensors is that plain form, bit for bit
    w_out, w_res = ths.heatmap_sample_fwd(tm, torch.from_numpy(pts),
                                          residual=True)
    assert torch.equal(w_out, out) and torch.equal(w_res, res)
    assert torch.equal(ths.heatmap_sample_bwd(w_res, torch.from_numpy(ct),
                                              (size, size)), grad)


def test_kink_convention_at_integer_coordinates():
    """On an exact integer pixel coordinate the derivative along that axis
    is 0 (the TPU backward's -sign(0) = 0), not a one-sided difference:
    through the forward's residual and the backward over it, and through
    autograd."""
    size = 65
    maps = np.zeros((1, size, size), np.float32)
    maps[0] = np.arange(size, dtype=np.float32)[None, :] * 2.0   # ramp in x
    tm = torch.from_numpy(maps)

    def grad(pts):
        _, res = ths.heatmap_sample_fwd(tm, torch.from_numpy(pts),
                                        residual=True)
        g = ths.heatmap_sample_bwd(res, torch.ones((1, 1)), (size, size))
        p = torch.from_numpy(pts).requires_grad_(True)
        (auto,) = torch.autograd.grad(ths.heatmap_sample(tm, p).sum(), p)
        assert torch.equal(auto, g)
        return res, g

    pts = np.array([[[0.5, 0.25]]], np.float32)       # ix = 48, iy = 40
    res, g = grad(pts)
    assert res[0, 0, 0].item() == 0.0 and g[0, 0, 0].item() == 0.0
    pts_off = pts + np.float32(1.0 / 64 / 4)            # quarter cell off
    res, g = grad(pts_off)
    np.testing.assert_allclose(res[0, 0, 0].item(), 2.0, rtol=1e-6)
    np.testing.assert_allclose(g[0, 0, 0].item(), 2.0 * 32.0, rtol=1e-6)


def test_no_graph_saves_no_residual(monkeypatch):
    """Under no_grad, or with points that do not require grad, the
    sampler runs the value-only forward and saves nothing; with a graph to
    record it runs the residual forward once and saves its residual
    alone, not the maps."""
    maps, pts = _inputs(64, seed=6, r=2)
    tm, tp = torch.from_numpy(maps), torch.from_numpy(pts)
    asked = []
    fwd = ths.heatmap_sample_fwd

    def spy(m, p, residual=False):
        asked.append(residual)
        return fwd(m, p, residual)

    monkeypatch.setattr(ths, "heatmap_sample_fwd", spy)
    p = tp.clone().requires_grad_(True)
    with torch.no_grad():
        out = ths.heatmap_sample(tm, p)
    assert out.grad_fn is None and asked == [False]
    out = ths.heatmap_sample(tm, tp)
    assert out.grad_fn is None and asked == [False, False]
    out = ths.heatmap_sample(tm, p)
    assert asked == [False, False, True]
    (res,) = out.grad_fn.saved_tensors
    assert res.shape == tp.shape
    torch.testing.assert_close(res, ths.plain_forward(tm, tp, True)[1],
                               rtol=0, atol=0)


def test_backward_without_a_residual_raises():
    """The backward never gathers the maps again: with no residual (the
    forward recorded none, as where only the maps require grad) it
    raises."""
    maps, pts = _inputs(64, seed=7)
    tm, tp = torch.from_numpy(maps), torch.from_numpy(pts)
    g = torch.ones((1, N))
    with pytest.raises(ValueError, match="residual"):
        ths.heatmap_sample_bwd(None, g, (64, 64))
    out = ths.heatmap_sample(tm.clone().requires_grad_(True), tp)
    with pytest.raises(ValueError, match="residual"):
        out.sum().backward()


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
    _, res = ths.heatmap_sample_fwd(tm, tp, residual=True)
    with pytest.raises(ValueError, match="shape"):
        ths.heatmap_sample_bwd(res, torch.ones((1, N - 1)), (64, 64))
    with pytest.raises(TypeError, match="dtype"):
        ths.heatmap_sample_bwd(res.double(), torch.ones((1, N)), (64, 64))
