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
from globalegomocap_tpu_torch.ops import fisheye  # noqa: E402
from globalegomocap_tpu_torch.ops import fused_energy as fe  # noqa: E402

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
                           "fused_stage_energy_noreproj": 0}
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
    with pytest.raises(ValueError, match="pose is on"):
        fe.stage_energy_and_grad(*bad)
    bad = list(args)
    bad[2] = args[2].half()
    with pytest.raises(TypeError):
        fe.stage_energy_and_grad(*bad)
