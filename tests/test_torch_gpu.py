"""The CUDA kernels of the port on the card: each against its plain
PyTorch version (tolerances of chip_smoke.compare_case), the launch
counter, the autograd backward and the wrapper's argument checks.

These need a CUDA card and skip without one.  The machine with the card
has no JAX, so run them there without the suite's conftest (which imports
JAX):

    python -m pytest tests/test_torch_gpu.py -m gpu --noconftest -q

This file imports nothing of JAX."""

import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402
from globalegomocap_tpu_torch.ops import cuda_build as cb  # noqa: E402
from globalegomocap_tpu_torch.ops import fisheye  # noqa: E402
from globalegomocap_tpu_torch.ops import fused_decode_energy as fde  # noqa
from globalegomocap_tpu_torch.ops import fused_energy as fe  # noqa: E402
from globalegomocap_tpu_torch.ops import heatmap_sample as hs  # noqa: E402
from globalegomocap_tpu_torch.ops import lbfgs_direction as ld  # noqa: E402

pytestmark = pytest.mark.gpu


@pytest.fixture
def gen():
    """A seeded CUDA generator; skips the test where there is no card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the machine with the card)")
    return torch.Generator(device="cuda").manual_seed(0)


@pytest.mark.parametrize("name,k,dtype", [
    ("fused_stage_energy", 8, torch.bfloat16),
    ("fused_stage_energy", 16, torch.float32),
    ("fused_stage_energy", 16, torch.bfloat16),
    ("fused_stage_energy_noreproj", 0, None)])
@pytest.mark.parametrize("r", [1, 2, 4])
def test_kernel_matches_plain_version(gen, name, k, dtype, r):
    ok, msg, _ = chip_smoke.compare_case(torch, fe, fisheye, name, r, 37, k,
                                         dtype, gen)
    assert ok, msg


def test_launch_counter_and_backward(gen):
    args = chip_smoke.stage1_inputs(2, 5, 8, torch.bfloat16, gen, torch,
                                    fe, fisheye)
    pose = args[0].clone().requires_grad_(True)
    fe.reset_launches()
    e = fe.fused_stage_energy(pose, *args[1:6], (args[6], args[7]),
                              *args[8:])
    assert fe.LAUNCHES == {"fused_stage_energy": 1,
                           "fused_stage_energy_noreproj": 0,
                           "heatmap_sample": 0, "heatmap_sample_bwd": 0,
                           "lbfgs_direction": 0,
                           "fused_decode_stage_energy": 0}
    ct = torch.randn(e.shape, generator=gen, device="cuda")
    (g_pose,) = torch.autograd.grad(e, pose, grad_outputs=ct)
    _, g = fe.stage_energy_and_grad(*args)
    torch.testing.assert_close(g_pose, ct[:, :, None, None] * g, rtol=0,
                               atol=0)
    assert fe.LAUNCHES["fused_stage_energy"] == 2


def test_wrapper_rejects_what_the_kernel_does_not_take(gen):
    args = list(chip_smoke.stage1_inputs(1, 3, 8, torch.float32, gen, torch,
                                         fe, fisheye))
    bad = list(args)
    bad[0] = args[0].transpose(2, 3).contiguous().transpose(2, 3)
    with pytest.raises(ValueError, match="contiguous"):
        fe.stage_energy_and_grad(*bad)
    bad = list(args)
    bad[1] = args[1].cpu()
    with pytest.raises(ValueError, match="is on cpu"):
        fe.stage_energy_and_grad(*bad)
    bad = list(args)
    bad[2] = args[2].half()
    with pytest.raises(TypeError):
        fe.stage_energy_and_grad(*bad)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("r,n", [(1, 37), (4, 1037), (4, 1800)])
def test_heatmap_sample_matches_plain_version(gen, dtype, r, n):
    ok, msg, _, _ = chip_smoke.compare_sampler(torch, hs, cb, r, n, dtype,
                                               gen)
    assert ok, msg


@pytest.mark.parametrize("m", [2, 10, 25])
@pytest.mark.parametrize("b", [12, 13])
def test_lbfgs_direction_matches_plain_version(gen, m, b):
    ok, msg, _ = chip_smoke.compare_direction(torch, ld, cb, b, m, gen)
    assert ok, msg


def test_heatmap_sample_counter_and_backward(gen):
    """One forward and one backward launch through autograd; the
    backward's point gradient is the backward kernel's output."""
    maps, pts = chip_smoke.sampler_inputs(4, 300, torch.bfloat16, gen,
                                          torch)
    ct = torch.randn((4, 300), generator=gen, device="cuda")
    p = pts.clone().requires_grad_(True)
    cb.reset_launches()
    out = hs.heatmap_sample(maps, p)
    (g,) = torch.autograd.grad(out, p, grad_outputs=ct)
    assert (cb.LAUNCHES["heatmap_sample"],
            cb.LAUNCHES["heatmap_sample_bwd"]) == (1, 1)
    torch.testing.assert_close(g, hs.heatmap_sample_bwd(maps, pts, ct),
                               rtol=0, atol=0)
    d = ld.lbfgs_direction(*chip_smoke.direction_inputs(3, 4, 64, gen,
                                                        torch))
    assert d.shape == (3, 64) and cb.LAUNCHES["lbfgs_direction"] == 1


def test_new_wrappers_reject_what_the_kernels_do_not_take(gen):
    maps, pts = chip_smoke.sampler_inputs(2, 50, torch.float32, gen, torch)
    with pytest.raises(TypeError, match="dtype"):
        hs.heatmap_sample_fwd(maps.half(), pts)
    with pytest.raises(ValueError, match="contiguous"):
        hs.heatmap_sample_fwd(maps, pts.transpose(0, 1).contiguous()
                              .transpose(0, 1))
    with pytest.raises(ValueError, match="is on cpu"):
        hs.heatmap_sample_fwd(maps, pts.cpu())
    args = list(chip_smoke.direction_inputs(3, 4, 64, gen, torch))
    bad = list(args)
    bad[4] = args[4].to(torch.uint8)
    with pytest.raises(TypeError, match="valid"):
        ld.lbfgs_direction(*bad)
    bad = list(args)
    bad[1] = args[1].transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        ld.lbfgs_direction(*bad)


@pytest.mark.parametrize("r,b,k,dtype", [(2, 192, 8, torch.bfloat16),
                                         (4, 37, 16, torch.float32),
                                         (4, 300, 8, torch.bfloat16)])
def test_decode_energy_matches_plain_version(gen, r, b, k, dtype):
    """Kernel 5 against its plain version (chip_smoke.decode_check), up to
    1,200 rows (more blocks than the card holds at once)."""
    ok, msg, _ = chip_smoke.compare_decode(torch, fe, fde, fisheye, r, b, k,
                                           dtype, gen)
    assert ok, msg


def test_decode_energy_counter_and_backward(gen):
    """One launch through autograd; the backward is ct * dE/dh0."""
    args = chip_smoke.decode_inputs(2, 5, 8, torch.bfloat16, gen, torch, fe,
                                    fde, fisheye)
    h0 = args[0].clone().requires_grad_(True)
    cb.reset_launches()
    e = fde.fused_decode_stage_energy(h0, args[1], *args[2:7],
                                      (args[7], args[8]), *args[9:])
    ct = torch.randn(e.shape, generator=gen, device="cuda")
    (g,) = torch.autograd.grad(e, h0, grad_outputs=ct)
    assert cb.LAUNCHES["fused_decode_stage_energy"] == 1
    _, gh0 = fde.decode_energy_and_grad(*args)
    torch.testing.assert_close(g, ct[:, :, None, None] * gh0, rtol=0, atol=0)
    with pytest.raises(ValueError, match="contiguous"):
        fde.decode_energy_and_grad(args[0].transpose(2, 3).contiguous()
                                   .transpose(2, 3), *args[1:])
