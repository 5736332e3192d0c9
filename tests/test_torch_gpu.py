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


ENERGY_CASES = [
    ("fused_stage_energy", k, dtype, placement)
    for k, dtype in ((8, torch.bfloat16), (16, torch.float32),
                     (16, torch.bfloat16), (24, torch.float32),
                     (24, torch.bfloat16))
    for placement in chip_smoke.PLACEMENTS] + [
    ("fused_stage_energy_noreproj", 0, None, "near")]


@pytest.mark.parametrize("name,k,dtype,placement", ENERGY_CASES)
@pytest.mark.parametrize("b", [1, 37, 192])
@pytest.mark.parametrize("r", [1, 2, 3, 4])
def test_kernel_matches_plain_version(gen, name, k, dtype, placement, r, b):
    """Kernels 1 and 2 against their plain version, with the crop
    coordinates around the crop's middle, pushed off it on every side and
    exactly on integer cells (chip_smoke.stage1_inputs), over R, B and
    k."""
    ok, msg, _ = chip_smoke.compare_case(torch, fe, fisheye, name, r, b, k,
                                         dtype, gen, placement)
    assert ok, msg


@pytest.mark.parametrize("r,b", [(2, 192), (1, 192), (4, 192), (2, 3840)])
def test_energy_plan_at_the_timed_shapes(gen, r, b):
    """The kernel source's plan (`fused_energy_plan`) at phase 4's shapes:
    one (probe, window) row a block, so R * B blocks of 160 threads (L =
    150 rounded up to whole warps), with the row's pose, acceleration and
    bone scratch (9 L floats) and the (5, 32) partial sums in shared
    memory."""
    n = chip_smoke.L
    assert fe.plan(r, b, n) == fe.Plan(160, 4 * (9 * n + 160), r * b)


def test_energy_wrapper_raises_for_a_shape_the_plan_refuses(gen):
    """69 frames make L = 1035 points, one thread each: a row does not fit
    a block of 1024 threads, so both wrappers raise ValueError naming the
    shape and launch nothing (the plain version would take it)."""
    t = 69
    args = list(chip_smoke.stage1_inputs(1, 3, 8, torch.float32, gen, torch,
                                         fe, fisheye))
    pose = torch.randn((1, 3, 3, 15 * t), device="cuda")
    anchor, bone = pose[0].clone(), torch.ones((3, 15 * t), device="cuda")
    crops = torch.rand((3, 64, 15 * t), device="cuda")
    ox = oy = torch.zeros((3, 15 * t), device="cuda")
    cb.reset_launches()
    with pytest.raises(ValueError, match="R=1, B=3, L=1035"):
        fe.stage_energy_and_grad(pose, anchor, crops, ox, oy, bone,
                                 *args[6:8], t, 15, *args[10:])
    with pytest.raises(ValueError, match="L=1035"):
        fe.stage_energy_and_grad_noreproj(pose, anchor, bone, args[6], t,
                                          15)
    assert cb.LAUNCHES["fused_stage_energy"] == 0
    assert cb.LAUNCHES["fused_stage_energy_noreproj"] == 0


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m", [2, 10, 25])
@pytest.mark.parametrize("b", [12, 13])
def test_lbfgs_direction_matches_plain_version(gen, m, b, dtype):
    ok, msg, _ = chip_smoke.compare_direction(torch, ld, cb, b, m, gen,
                                              dtype)
    assert ok, msg


@pytest.mark.parametrize("dtype,d", [(torch.float32, 2050),
                                     (torch.bfloat16, 36)])
def test_lbfgs_direction_takes_any_d(gen, dtype, d):
    """A d whose slices are not whole 16-byte rows runs zero-padded to
    the plan's width, and the direction comes back at d, against the
    plain version `two_loop_direction`."""
    ok, msg, _ = chip_smoke.compare_direction(torch, ld, cb, 13, 10, gen,
                                              dtype, d)
    assert ok, msg
    width, _ = ld.padded_plan(13, 10, d, dtype, torch.device("cuda"))
    assert width > d and "padded to" in msg


def test_lbfgs_direction_raises_for_a_cluster_the_card_cannot_hold(
        gen, monkeypatch):
    """A plan of 32 CTAs a lane splits d = 2048 into 16-byte slices that
    fit, but Hopper schedules clusters of at most 16: the wrapper raises,
    naming the shape and the cluster, and launches nothing in its
    place."""
    args = chip_smoke.direction_inputs(3, 4, 2048, gen, torch)
    monkeypatch.setattr(ld, "plan", lambda *a: ld.Plan(32, 32, 0))
    cb.reset_launches()
    with pytest.raises(RuntimeError, match="cannot schedule a cluster of "
                                           "32 CTAs .* B=3, m=4, d=2048"):
        ld.lbfgs_direction(*args)
    assert cb.LAUNCHES["lbfgs_direction"] == 0


@pytest.mark.parametrize("b,m,dtype,d,cluster,threads", [
    (12, 25, torch.float32, 2048, 2, 128),    # path A: C = 1 needs 417 KB
    (13, 25, torch.bfloat16, 2048, 2, 128),
    (192, 10, torch.float32, 2048, 2, 128),   # C = 1 fits, in 256 threads
    (192, 2, torch.float32, 2048, 2, 128),
    (3, 4, torch.float32, 64, 1, 32),
    (12, 2, torch.float32, 32768, 16, 256),   # none fits in 128 threads
])
def test_plan_fits_shared_memory_with_few_threads(gen, b, m, dtype, d,
                                                  cluster, threads):
    """The kernel source's launch plan on an H100 (232,448 bytes of
    shared memory a block may opt into): the smallest cluster whose slice
    fits its shared memory in at most 128 threads (one warp per
    scheduler), else the largest that fits."""
    p = ld.plan(b, m, d, dtype, torch.device("cuda"))
    assert (p.cluster, p.threads) == (cluster, threads)
    slice_ = d // cluster
    elem = torch.empty((), dtype=dtype).element_size()
    assert slice_ * elem % 16 == 0 and slice_ <= 8 * threads
    assert elem * slice_ * (2 * m + 1) <= p.smem <= 232448  # H100 opt-in


def test_plan_raises_where_nothing_fits(gen):
    dev = torch.device("cuda")
    with pytest.raises(ValueError, match="B=12, m=25, d=2050"):
        ld.plan(12, 25, 2050, torch.float32, dev)   # no 16-byte slices
    with pytest.raises(ValueError, match="m=2000"):
        ld.plan(12, 2000, 2048, torch.float32, dev)  # too many slots


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


def test_decode_energy_ragged_block_and_row_edges(gen):
    """401 rows: the plan's rows a CTA (4) leave one row in the last CTA;
    every other window's h0 is scaled by 50, so a frame that leaked across
    a row's SAME padding into its neighbour would show in the neighbour's
    pose, energy and dE/dh0 (held by chip_smoke.decode_check)."""
    args = list(chip_smoke.decode_inputs(1, 401, 8, torch.bfloat16, gen,
                                         torch, fe, fde, fisheye))
    p = fde.plan(args[1].dims, 401, torch.device("cuda"))
    assert 401 % p.rows_per_block != 0
    h0 = args[0].clone()
    h0[:, ::2] *= 50.0
    args[0] = h0
    out = fde.decode_energy_and_grad(*args, with_pose=True)
    torch.cuda.synchronize()
    ok, de, dgh, rel, _, _, failed = chip_smoke.decode_check(
        torch, fe, fde, tuple(args), out)
    assert ok, (failed, de, dgh, rel)


def test_decode_plan_at_the_timed_row_counts(gen):
    """The kernel source's plan on an H100 (132 SMs, 232,448 bytes of
    shared memory a CTA): the least time by its cost model, waves x (185
    + 1.0 x chunks) us; one CTA a cluster; the L2 bytes are the CTAs'
    weight reads."""
    dims = chip_smoke.DEC_DIMS
    weight_bytes = 4 * sum(fde.passes_floats(dims))
    for rows, rb, stage in ((192, 2, 49152), (384, 3, 24576),
                            (768, 3, 24576), (1200, 4, 24576)):
        p = fde.plan(dims, rows, torch.device("cuda"))
        assert (p.rows_per_block, p.cluster, p.stage_bytes) == (
            rb, 1, stage), (rows, p)
        assert p.ctas == -(-rows // rb) and 2 <= p.stages <= 8
        assert p.smem <= 232448 and p.l2_bytes == p.ctas * weight_bytes


def test_decode_wrapper_raises_for_a_chain_the_plan_cannot_take(gen):
    """A 4096-channel hidden layer: one row's activations do not fit a
    block's shared memory, so the wrapper raises ValueError naming the
    chain and launches nothing."""
    layers = [(torch.zeros(3, 512, 4096, device="cuda"),
               torch.zeros(4096, device="cuda")),
              (torch.zeros(3, 4096, 45, device="cuda"),
               torch.zeros(45, device="cuda"))]
    args = list(chip_smoke.decode_inputs(1, 3, 8, torch.bfloat16, gen,
                                         torch, fe, fde, fisheye))
    args[1] = fde.pack_layers(layers)
    cb.reset_launches()
    with pytest.raises(ValueError, match=r"channels \(512, 4096, 45\)"):
        fde.decode_energy_and_grad(*args)
    assert cb.LAUNCHES["fused_decode_stage_energy"] == 0


def test_path_d_at_a_small_size(gen, tmp_path):
    """chip_smoke's path D on two 26-frame chunks at 3 + 3 iterations:
    the parity CLI with no --solver flag on .pth.tar priors, heatmap_sample
    and its backward launched once per batched stage-1 call the solver
    reports, a shadow run, a plain-version run and one chunk at --solver
    adam, every check passing."""
    fails = chip_smoke.Failures()
    work = chip_smoke.make_work(torch, 0, str(tmp_path), shape=(1, 2, 26))
    launches = chip_smoke.path_d_phase(torch, 0, "cuda", fails, "test",
                                       work, n_chunks=2, n_frames=26,
                                       iters=3)
    assert fails.items == []
    assert launches["heatmap_sample"] > 0
