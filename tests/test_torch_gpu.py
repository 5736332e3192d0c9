"""The CUDA kernels of the port on the card: each against its plain
PyTorch version (tolerances of chip_smoke.compare_case), the launch
counter, the autograd backward and the wrapper's argument checks; and
the streamed serve on the card: a sync-free warm dispatch, device
staging, the prefetcher's stream hand-off and chip_smoke's phase 3h at a
small size; chip_smoke's phase 3i (evaluate_all) at a small size and the
device trace; prior-bank selection through device staging and one joint
train step against the CPU's; the preprocessing ETL's argmax and
unprojection, RANSAC, the two-view pose and `process_sequence`, card
against CPU; Orbax checkpoints on the card: the JAX-written fixture read
and resumed, a trainer's Orbax checkpoint resumed like its msgpack twin,
and an Orbax prior feeding a solve through kernels 1 and 2; the parallel
paths on the card: the collectives over two gloo ranks sharing cuda:0
and chip_smoke's phase 3n (one NCCL rank, two gloo ranks) at a small
size; the GMM prior, the camera and reprojection energies and the
bone-length ConvVAE, card against CPU (chip_smoke's phase 3p (b)-(d)).

These need a CUDA card and skip without one.  The machine with the card
has no JAX, so run them there without the suite's conftest (which imports
JAX):

    python -m pytest tests/test_torch_gpu.py -m gpu --noconftest -q

This file imports nothing of JAX."""

import os
import sys

import numpy as np
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
    """Both forward variants, the residual and the backward over it
    against the plain versions (`chip_smoke.compare_sampler`)."""
    ok, msg, _, _ = chip_smoke.compare_sampler(torch, hs, cb, r, n, dtype,
                                               gen)
    assert ok, msg


def test_heatmap_sample_matches_plain_version_at_path_b(gen):
    """The same at path B's shape: R=4 over a serve batch's 28,800 bf16
    maps."""
    ok, msg, _, _ = chip_smoke.compare_sampler(
        torch, hs, cb, 4, chip_smoke.PATH_B_POINTS, torch.bfloat16, gen)
    assert ok, msg


@pytest.mark.parametrize("threads", [64, 128, 256])
def test_heatmap_sample_block_sizes_agree_and_count_nothing(gen, threads):
    """Every block size the timing sweeps gives the launch rule's
    results bit for bit, and the sweep's entry points count no launch."""
    maps, pts = chip_smoke.sampler_inputs(4, 1800, torch.float32, gen,
                                          torch)
    g = torch.randn((4, 1800), generator=gen, device="cuda")
    out, res = hs.heatmap_sample_fwd(maps, pts, residual=True)
    d = hs.heatmap_sample_bwd(res, g, (64, 64))
    assert (hs.launch_threads(), hs.launch_threads(backward=True)) == (
        128, 256)
    cb.reset_launches()
    assert torch.equal(hs.fwd_at_block(maps, pts, threads), out)
    out_t, res_t = hs.fwd_at_block(maps, pts, threads, residual=True)
    assert torch.equal(out_t, out) and torch.equal(res_t, res)
    assert torch.equal(hs.bwd_at_block(res, g, (64, 64), threads), d)
    assert cb.LAUNCHES["heatmap_sample"] == 0
    assert cb.LAUNCHES["heatmap_sample_bwd"] == 0
    with pytest.raises(ValueError, match="threads"):
        hs.fwd_at_block(maps, pts, 96)


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
    """One forward and one backward launch for each value-and-grad
    evaluation through autograd; the forward saves the residual alone and
    the point gradient is the backward kernel's output over it.  A
    value-only call (no_grad) launches the forward alone."""
    maps, pts = chip_smoke.sampler_inputs(4, 300, torch.bfloat16, gen,
                                          torch)
    ct = torch.randn((4, 300), generator=gen, device="cuda")
    cb.reset_launches()
    for k in range(1, 4):
        p = pts.clone().requires_grad_(True)
        out = hs.heatmap_sample(maps, p)
        (res,) = out.grad_fn.saved_tensors
        (g,) = torch.autograd.grad(out, p, grad_outputs=ct)
        assert (cb.LAUNCHES["heatmap_sample"],
                cb.LAUNCHES["heatmap_sample_bwd"]) == (k, k)
    with torch.no_grad():
        hs.heatmap_sample(maps, p)
    assert (cb.LAUNCHES["heatmap_sample"],
            cb.LAUNCHES["heatmap_sample_bwd"]) == (4, 3)
    torch.testing.assert_close(res, hs.heatmap_sample_fwd(
        maps, pts, residual=True)[1], rtol=0, atol=0)
    torch.testing.assert_close(g, hs.heatmap_sample_bwd(res, ct, (64, 64)),
                               rtol=0, atol=0)
    with pytest.raises(ValueError, match="residual"):
        hs.heatmap_sample_bwd(None, ct, (64, 64))
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
    _, res = hs.heatmap_sample_fwd(maps, pts, residual=True)
    g = torch.ones((2, 50), device="cuda")
    with pytest.raises(ValueError, match="is on cpu"):
        hs.heatmap_sample_bwd(res, g.cpu(), (64, 64))
    with pytest.raises(ValueError, match="aligned"):
        hs.heatmap_sample_bwd(res.view(-1)[1:197].view(2, 49, 2),
                              g[:, :49].contiguous(), (64, 64))
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


def test_evaluate_all_phase_at_a_small_size(gen, tmp_path):
    """chip_smoke's phase 3i on 2 sequences of two 26-frame chunks at
    3 + 3 iterations: evaluate_all at its defaults on msgpack priors
    (kernel 3 once per stage-1 call), a shadow and a plain-version run,
    kernels 1 and 2 with and without the calibration JSON, mode='vmap'
    with the direction kernel, and the CLI's --save and --profile_dir,
    every check passing."""
    fails = chip_smoke.Failures()
    work = chip_smoke.make_work(torch, 0, str(tmp_path), shape=(1, 1, 26))
    launches = chip_smoke.evaluate_all_phase(
        torch, 0, "cuda", fails, "test", work, shape=(2, 2, 26), iters=3)
    assert fails.items == []
    assert launches["fused_stage_energy"] == 2 * 4
    assert launches["lbfgs_direction"] == 2 * (3 + 3)
    assert launches["heatmap_sample"] > 0


def test_device_trace_records_the_card(gen, tmp_path):
    """utils/profiling.device_trace on the card: the Chrome trace holds
    the kernel's launch."""
    import json
    from globalegomocap_tpu_torch.utils.profiling import device_trace
    maps, pts = chip_smoke.sampler_inputs(2, 50, torch.float32, gen, torch)
    with device_trace(str(tmp_path)):
        hs.heatmap_sample(maps, pts)
        torch.cuda.synchronize()
    (name,) = os.listdir(tmp_path)
    with open(tmp_path / name) as f:
        events = json.load(f)["traceEvents"]
    assert any("heatmap_sample" in e.get("name", "") and
               e.get("cat") == "kernel" for e in events)


def _small_optimizer(tier="bfloat16_delta", **flags):
    """Serve's configuration at the tiny prior with random weights, on the
    card, and two 26-frame synthetic chunks."""
    from globalegomocap_tpu_torch.cli import serve
    from globalegomocap_tpu_torch.data.synthetic import synthetic_chunk
    from globalegomocap_tpu_torch.models.conv_vae import init_random
    from globalegomocap_tpu_torch.optimize.driver import (
        SequenceOptimizer, build_model)
    argv = ["--data_root", ".", "--local_ckpt", "-", "--global_ckpt", "-",
            "--latent_dim", "32", "--hidden_dims", "8,8,16,16,32",
            "--compute_dtype", tier]
    for k, v in flags.items():
        argv += ["--" + k, str(v)]
    cfg = serve.config_from_args(serve.build_parser().parse_args(argv))
    model = build_model(cfg)
    sd = init_random(model, torch.Generator().manual_seed(0)).state_dict()
    opt = SequenceOptimizer(model, sd, sd, cfg, device="cuda")
    return opt, [synthetic_chunk(26, seed=s) for s in (1, 2)]


def test_serve_defaults_phase_at_a_small_size(gen, tmp_path):
    """chip_smoke's phase 3h on 3 sequences of two 26-frame chunks: the
    CLI at its defaults against inline, a sync-free dispatch, prefetched
    and device staging, the guard policy, the decoders and watch mode,
    every check passing."""
    fails = chip_smoke.Failures()
    work = chip_smoke.make_work(torch, 0, str(tmp_path), shape=(2, 2, 26))
    launches = chip_smoke.serve_defaults_phase(
        torch, 0, "cuda", fails, "test", work, shape=(3, 2, 26), rounds=1)
    assert fails.items == []
    assert launches["fused_stage_energy"] == 3 * 13


def test_warm_dispatch_is_sync_free(gen):
    """A warm optimize_chunks_batched only queues work: no synchronising
    call under set_sync_debug_mode('error'), at every tier serve runs."""
    for tier in ("bfloat16_delta", "float32"):
        opt, cs = _small_optimizer(tier)
        staged = opt.stage(cs, on_host=True)
        opt.optimize_chunks_batched(staged, mode="flat")
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            res = opt.optimize_chunks_batched(staged, mode="flat")
        finally:
            torch.cuda.set_sync_debug_mode(0)
        assert torch.isfinite(res.optimized).all()


@pytest.mark.parametrize("coverage", [None, 0.1])
@pytest.mark.parametrize("guard_crop", [16, 0])
def test_device_staging_equals_host_staging_on_the_card(gen, coverage,
                                                        guard_crop):
    opt, cs = _small_optimizer(guard_crop=guard_crop)
    dev = opt.stage(cs, coverage=coverage, on_host=False)
    host = opt.stage(cs, coverage=coverage, on_host=True)
    for a, b in zip(dev.tensors(), host.tensors()):
        assert a.is_cuda and torch.equal(a, b)
    assert abs(dev.crop_coverage - host.crop_coverage) <= \
        1e-6 * abs(host.crop_coverage)


def test_prefetcher_hands_batches_over_by_event(gen):
    """StagePrefetcher stages on its own stream: each batch carries an
    event, equals inline staging bit for bit, and solves to inline
    staging's answer; the device memory stays bounded by the in-flight
    depth over the submissions."""
    from globalegomocap_tpu_torch.optimize.streaming import (
        StagePrefetcher, StreamingOptimizer)
    opt, cs = _small_optimizer()
    batches = [cs] * 6
    service = StreamingOptimizer(opt, max_in_flight=2, stage_on_host=True)
    mem = []
    for staged in StagePrefetcher(opt, batches, depth=2, on_host=True):
        assert isinstance(staged.ready, torch.cuda.Event)
        service.submit_batch(staged)
        ref = opt.stage(cs, coverage=staged.crop_coverage, on_host=True)
        assert all(torch.equal(a, b) for a, b in
                   zip(staged.tensors(), ref.tensors()))
        service._completed.clear()
        mem.append(torch.cuda.memory_allocated())
    out = service.drain()
    direct = opt.optimize_chunks_batched(opt.stage(cs, on_host=True),
                                         mode="flat")
    torch.testing.assert_close(out[-1].optimized, direct.optimized,
                               rtol=1e-5, atol=1e-6)
    assert max(mem[2:]) <= mem[1] + sum(
        t.numel() * t.element_size() for t in ref.tensors()) + sum(
        x.numel() * x.element_size() for x in direct)


def _tiny_trainer(device, windows, noise):
    from globalegomocap_tpu_torch.config import TrainConfig
    from globalegomocap_tpu_torch.data.amass import AmassWindows
    from globalegomocap_tpu_torch.models.conv_vae import ConvVAE
    from globalegomocap_tpu_torch.train.train_vae import Trainer
    cfg = TrainConfig(latent_dim=32, batch_size=32, learning_rate=2e-3,
                      kl_weight=0.5, log_step=0)
    model = ConvVAE(latent_dim=32, seq_len=10, hidden_dims=(16, 16, 32, 32,
                                                            64))
    ds = AmassWindows(windows)
    return Trainer(cfg, ds, ds, model, device=device,
                   noise_fn=lambda step, shape, dtype: noise[step].to(
                       device, dtype))


def test_train_step_on_the_card_matches_the_cpu(gen):
    """One train step of the tiny prior on the card against the same step
    on the CPU, from the same state (the Flax-like init from the same
    seed) and noise: the loss (1e-5 relative), the running statistics
    (1e-5 absolute and relative: the card's and the CPU's float32
    reductions of the batch statistics differ in order), the parameters
    within 2.5 lr (Adam's normalised first update
    turns rounding on near-zero gradients into +-lr flips); float32 on
    the card, TF32 off."""
    from globalegomocap_tpu_torch.data.synthetic import synthetic_amass
    from globalegomocap_tpu_torch.data.amass import window_sequences
    windows = window_sequences(synthetic_amass(3, 80, seed=1),
                               local_pose=True)
    noise = torch.randn(1, 32, 32, generator=torch.Generator().manual_seed(1))
    cpu, card = (_tiny_trainer(d, windows, noise) for d in ("cpu", "cuda"))
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
    batch = torch.from_numpy(windows[:32])
    m_cpu = cpu._train_step(batch, 0)
    m_card = card._train_step(batch.cuda(), 0)
    assert float(m_card["loss"]) == pytest.approx(float(m_cpu["loss"]),
                                                  rel=1e-5)
    a, b = cpu.model.state_dict(), card.model.state_dict()
    for name, p in cpu.model.named_parameters():
        gap = float((b[name].cpu() - a[name]).abs().max())
        assert gap <= 2.5 * 2e-3, (name, gap)
    for name in a:
        if "running" in name:
            torch.testing.assert_close(b[name].cpu(), a[name], rtol=1e-5,
                                       atol=1e-5,
                                       msg=lambda m, name=name: f"{name}: {m}")
    assert all(p.dtype == torch.float32 and p.is_cuda
               for p in card.model.parameters())


def test_bank_selection_through_device_staging_on_the_card(gen):
    """A bank of two random pairs behind serve's configuration on the
    card: device staging measures each batch where it lies (one scalar
    read back), within 1e-5 of the numpy statistic of the same chunks;
    the smooth chunk gets 'smooth', the jerky one 'jerky', each solved to
    finite poses."""
    from globalegomocap_tpu_torch.data.synthetic import (
        synthetic_chunk, synthetic_motion)
    from globalegomocap_tpu_torch.models.conv_vae import init_random
    from globalegomocap_tpu_torch.optimize.driver import (
        SequenceOptimizer, build_model)
    from globalegomocap_tpu_torch.optimize.prior_bank import (
        PriorBank, motion_accel_stat)
    cfg = _small_optimizer()[0].cfg
    pairs = [init_random(build_model(cfg), torch.Generator().manual_seed(s))
             .state_dict() for s in (1, 2)]
    stats = [motion_accel_stat(synthetic_motion(100, seed=0, **kw),
                               window=10)
             for kw in ({}, chip_smoke.JERKY)]
    bank = PriorBank().add("smooth", pairs[0], pairs[0], stats[0]).add(
        "jerky", pairs[1], pairs[1], stats[1])
    opt = SequenceOptimizer(build_model(cfg), pairs[0], pairs[0], cfg,
                            device="cuda", prior_bank=bank)
    for name, kw in (("smooth", {}), ("jerky", chip_smoke.JERKY)):
        chunks = [synthetic_chunk(26, seed=s, **kw) for s in (1, 2)]
        staged = opt.stage(chunks, on_host=False)
        assert staged.est.is_cuda
        want = motion_accel_stat(np.stack([c.estimated_local
                                           for c in chunks]), window=10)
        assert staged.accel_mean == pytest.approx(want, rel=1e-5)
        res = opt.optimize_chunks_batched(staged, mode="flat")
        assert opt.last_prior_name == name
        assert torch.isfinite(res.optimized).all()


def test_joint_train_step_on_the_card_matches_the_cpu(gen):
    """One joint train step of the tiny joint prior on the card against
    the same step on the CPU, from the same state (the Flax-like init of
    the same seed) and noise: the six metrics (1e-5 relative; a KLD
    within 1e-6 absolute, a sum of O(1) differences near 0), every
    gradient and Adam's first moment within 1e-2 of the CPU's in relative
    L2 norm, the second moment (a square) within 2e-2, the running
    statistics (1e-5, as test_train_step_on_the_card_matches_the_cpu) and
    the parameters within 2.5 lr.  Not elementwise: the two float32
    forwards differ by a few 1e-6, so a leaky-ReLU input that close to 0
    can take the other slope (0.01 for 1) on one side.  One such input
    (|z| = 2.6e-6 in float64, the first decoder block) moved the card's
    local-branch gradients by up to 2.7e-3 of a tensor's largest
    magnitude and 1.7e-3 in L2 norm, where the CPU's stayed within 1.5e-5
    of float64 (NVIDIA H100 80GB HBM3).  A wrong gradient path moves
    them by far more: with the lift detached, 38 of the 76 held tensors
    by over 1e-2 and the worst by 119 % (on the CPU)."""
    from globalegomocap_tpu_torch.config import TrainConfig
    from globalegomocap_tpu_torch.data.hdf5 import (
        sequence_windows_with_cameras)
    from globalegomocap_tpu_torch.data.synthetic import synthetic_amass
    from globalegomocap_tpu_torch.models.joint_vae import JointLocalGlobalVAE
    from globalegomocap_tpu_torch.train.train_joint import JointTrainer
    parts = [sequence_windows_with_cameras(s, 10, 25, True)
             for s in synthetic_amass(2, 70, seed=3)]
    poses = np.concatenate([p[1] for p in parts]).reshape(-1, 10, 45)
    cams = np.concatenate([p[2] for p in parts])
    noise = torch.randn(2, 32, 32, generator=torch.Generator().manual_seed(1))
    cfg = TrainConfig(latent_dim=32, batch_size=32, learning_rate=2e-3,
                      kl_weight=0.05)

    def trainer(device):
        model = JointLocalGlobalVAE(latent_dim=32, seq_len=10,
                                    hidden_dims=(8, 8, 16, 16, 32))
        return JointTrainer(cfg, poses, cams, model, device=device,
                            noise_fn=lambda step, shape, dtype: tuple(
                                n.to(device, dtype) for n in noise))
    cpu, card = trainer("cpu"), trainer("cuda")
    p, c = torch.from_numpy(poses[:32]), torch.from_numpy(cams[:32])
    m_cpu = cpu.train_step(p, c)
    m_card = card.train_step(p.cuda(), c.cuda())
    assert list(m_card) == list(m_cpu)
    for k in m_cpu:
        assert float(m_card[k]) == pytest.approx(
            float(m_cpu[k]), rel=1e-5, abs=1e-6 if "kld" in k else 0), k
    on_card = dict(card.model.named_parameters())
    held = 0
    for name, p in cpu.model.named_parameters():
        if float(p.grad.norm()) < 1e-6:
            continue    # a conv bias before BN: 0 but for rounding
        held += 1
        q = on_card[name]
        for what, want, got, tol in (
                ("grad", p.grad, q.grad, 1e-2),
                ("exp_avg", cpu.optimizer.state[p]["exp_avg"],
                 card.optimizer.state[q]["exp_avg"], 1e-2),
                ("exp_avg_sq", cpu.optimizer.state[p]["exp_avg_sq"],
                 card.optimizer.state[q]["exp_avg_sq"], 2e-2)):
            err = float((got.cpu() - want).norm() / want.norm())
            assert err <= tol, (name, what, err)
    assert held == 76, held     # of 96: the 20 conv biases before BN out
    a, b = cpu.model.state_dict(), card.model.state_dict()
    for name, _ in cpu.model.named_parameters():
        gap = float((b[name].cpu() - a[name]).abs().max())
        assert gap <= 2.5 * 2e-3, (name, gap)
    for name in a:
        if "running" in name:
            torch.testing.assert_close(b[name].cpu(), a[name], rtol=1e-5,
                                       atol=1e-5)


def test_heatmap_argmax_and_camera2world_on_the_card_match_the_cpu(gen):
    """The lift's two steps, card against CPU: the argmax's first-maximum
    rule on ties (integer-valued maps), all-zero and negative maps (their
    joints zeroed); camera2world in float32 at radii up to 680 px."""
    from globalegomocap_tpu_torch.ops.skeleton import heatmap_argmax
    rng = np.random.default_rng(0)
    maps = rng.integers(0, 4, size=(40, 15, 64, 64)).astype(np.float32)
    maps[3] = 0.0
    maps[4] = -1.0
    want = heatmap_argmax(torch.from_numpy(maps))
    got = heatmap_argmax(torch.from_numpy(maps).cuda())
    for g, w in zip(got, want):
        torch.testing.assert_close(g.cpu(), w, rtol=0, atol=0)
    cam = fisheye.default_camera("egosyn")
    ang = rng.uniform(0, 2 * np.pi, 20000)
    rad = rng.uniform(0, 680, 20000)
    px = torch.from_numpy((cam.center.numpy() + np.stack(
        [rad * np.cos(ang), rad * np.sin(ang)], 1)).astype(np.float32))
    depth = torch.from_numpy(rng.uniform(0.2, 3, 20000).astype(np.float32))
    want = fisheye.camera2world(cam, px, depth)
    got = fisheye.camera2world(cam.to("cuda"), px.cuda(), depth.cuda())
    torch.testing.assert_close(got.cpu(), want, rtol=2e-6, atol=2e-6)


def test_ransac_and_recover_pose_on_the_card_match_the_cpu(gen):
    """cuSOLVER's SVDs against the CPU's LAPACK: the RANSAC fit on the
    same hypotheses, the public RANSAC on each device's own draws (one
    inlier set, so the same answer), and the two-view pose."""
    from scipy.spatial.transform import Rotation
    from globalegomocap_tpu_torch.ops import epipolar
    from globalegomocap_tpu_torch.ops import umeyama as um
    rng = np.random.default_rng(0)
    P = rng.normal(size=(60, 3))
    Q = P @ Rotation.random(random_state=2).as_matrix() * 2.2 + 0.5
    bad = rng.choice(60, size=12, replace=False)
    Q[bad] += rng.normal(scale=5.0, size=(12, 3))
    P, Q = (torch.from_numpy(a.astype(np.float32)) for a in (P, Q))
    idx = torch.argsort(torch.rand(80, 60, generator=torch.Generator()
                                   .manual_seed(0)), dim=-1)[:, :4]
    for want, got in ((um._ransac_fit(P, Q, idx, 0.2),
                       um._ransac_fit(P.cuda(), Q.cuda(), idx.cuda(), 0.2)),
                      (um.umeyama_ransac(P, Q),
                       um.umeyama_ransac(P.cuda(), Q.cuda()))):
        for g, w in zip(got, want):
            torch.testing.assert_close(g.cpu(), w, rtol=1e-4, atol=1e-5)
    X = rng.uniform(-1, 1, size=(40, 3)) + np.array([0, 0, 4.0])
    R = Rotation.from_euler("xyz", [5, -8, 3], degrees=True).as_matrix()
    x2 = X @ R.T + np.array([1.0, 0.2, -0.1]) / np.linalg.norm([1, 0.2, -0.1])
    r1, r2 = (torch.from_numpy((v / np.linalg.norm(v, axis=1, keepdims=True))
                               .astype(np.float32)) for v in (X, x2))
    want = epipolar.recover_pose(r1, r2)
    got = epipolar.recover_pose(r1.cuda(), r2.cuda())
    for g, w, tol in zip(got, want, (1e-4, 1e-4, 1e-3)):
        torch.testing.assert_close(g.cpu(), w, rtol=0, atol=tol)


def test_process_sequence_on_the_card_matches_the_cpu(gen, tmp_path):
    """The ETL on a tiny raw capture (chip_smoke.write_raw_capture, 3
    chunks of 26 frames), card against CPU: the same chunk directories,
    pose fields within 1e-4 m, camera matrices within 1e-5."""
    from globalegomocap_tpu_torch.tools.process_test_data import (
        process_sequence)
    paths = chip_smoke.write_raw_capture(str(tmp_path / "raw"), 104, 130,
                                         26, 130, 26, seed=0)
    out = {}
    for dev in ("cuda", "cpu"):
        out[dev] = process_sequence(
            paths["slam"], paths["heatmap_dir"], paths["depth_dir"],
            paths["gt"], str(tmp_path / dev), 26, 130, chunk_size=26,
            mat_start_frame=26, device=dev)
    assert [os.path.basename(os.path.dirname(p)) for p in out["cuda"]] == [
        "data_start_26_end_52", "data_start_52_end_78",
        "data_start_78_end_104"]
    pose, cam, maps = chip_smoke.chunks_agree(
        [os.path.dirname(p) for p in out["cuda"]],
        [os.path.dirname(p) for p in out["cpu"]])
    assert pose <= 1e-4 and cam <= 1e-5 and maps, (pose, cam)


# ---------------------------------------------------------------------------
# Orbax checkpoints on the card
# ---------------------------------------------------------------------------

def test_orbax_fixture_reads_and_resumes_on_the_card(gen):
    """The JAX-written fixture (tests/torch_fixtures/orbax_jax/) read bit
    for bit against its expected.npz, and a port trainer on the card
    resumed from its epoch checkpoint: the state read back from the card
    equal bit for bit to the fixture's."""
    n, bad = chip_smoke.read_fixture()
    assert n > 200 and bad == []
    ft = chip_smoke.fixture_trainer(torch, "cuda")
    step = ft.load_checkpoint(os.path.join(chip_smoke.ORBAX_FIXTURE,
                                           "checkpoints", "0.orbax"))
    want = {k: x for k, x in np.load(os.path.join(
        chip_smoke.ORBAX_FIXTURE, "expected.npz")).items()
        if k.startswith("epoch/")}
    assert step == int(want["epoch/step"]) > 0
    assert all(p.is_cuda for p in ft.model.parameters())
    assert chip_smoke.leaves_differ(chip_smoke.trainer_leaves(ft), want) == []


def test_trainer_saves_orbax_and_resumes_like_msgpack_on_the_card(
        gen, tmp_path):
    """A trainer on the card (the fixture's configuration) trains an epoch
    and saves it as Orbax and as msgpack; a trainer resumed from each holds
    the saver's state bit for bit, and one more epoch each (cuDNN
    deterministic) ends at the same step and eval (1e-5 relative, phase
    3j's resume bar)."""
    with chip_smoke.cudnn_deterministic(torch):
        tr = chip_smoke.fixture_trainer(torch, "cuda")
        tr.train(log_fn=lambda *_: None)
        saved = chip_smoke.trainer_leaves(tr)
        out = {}
        for fmt in ("orbax", "msgpack"):
            path = tr.save_checkpoint(str(tmp_path), 0, 1.0, fmt=fmt)
            t = chip_smoke.fixture_trainer(torch, "cuda")
            assert t.load_checkpoint(path) == tr.step
            assert chip_smoke.leaves_differ(chip_smoke.trainer_leaves(t),
                                            saved) == []
            t.train(log_fn=lambda *_: None)
            out[fmt] = (t.step, t.history[-1]["eval_mpjpe"])
    assert out["orbax"][0] == out["msgpack"][0] == 2 * tr.step
    assert out["orbax"][1] == pytest.approx(out["msgpack"][1], rel=1e-5)


def test_orbax_prior_feeds_a_solve_with_kernels_1_and_2(gen, tmp_path):
    """A random prior written by save_orbax and read back by
    load_prior_variables into serve's solve on the card: kernels 1 and 2
    launched, the optimized poses equal bit for bit to the solve on the
    prior it was written from (cuDNN deterministic)."""
    from globalegomocap_tpu_torch.models.checkpoint import (
        load_prior_variables, save_orbax)
    from globalegomocap_tpu_torch.models.conv_vae import init_random
    from globalegomocap_tpu_torch.models.convert import (
        params_from_flax, params_to_flax)
    from globalegomocap_tpu_torch.optimize.driver import (
        SequenceOptimizer, build_model)
    opt, chunks = _small_optimizer()
    sd = init_random(build_model(opt.cfg),
                     torch.Generator().manual_seed(0)).state_dict()
    path = str(tmp_path / "prior.orbax")
    save_orbax(params_to_flax(sd), path)
    back = params_from_flax(load_prior_variables(path, 10,
                                                 (8, 8, 16, 16, 32)))
    assert sorted(back) == sorted(sd)
    assert all(torch.equal(back[k], sd[k].cpu()) for k in sd)
    loaded = SequenceOptimizer(build_model(opt.cfg), back, back, opt.cfg,
                               device="cuda")
    with chip_smoke.cudnn_deterministic(torch):
        want = opt.optimize_chunks_batched(opt.stage(chunks, on_host=True),
                                           mode="flat").optimized
        cb.reset_launches()
        got = loaded.optimize_chunks_batched(
            loaded.stage(chunks, on_host=True), mode="flat").optimized
        torch.cuda.synchronize()
    assert cb.LAUNCHES["fused_stage_energy"] > 0
    assert cb.LAUNCHES["fused_stage_energy_noreproj"] > 0
    assert torch.equal(got, want)


def test_gloo_collectives_on_card_tensors(gen):
    """Two gloo ranks sharing cuda:0 (`parallel.mesh.spawn`): all_reduce
    and its backward, all_gather, one all_gather of a float32 and a bf16
    field and replicate, on CUDA tensors, which gloo takes as they are;
    each result back on the card.  (The worker module is imported from
    this file's directory: a package named `tests` may be installed on
    the machine with the card.)"""
    from globalegomocap_tpu_torch.parallel import mesh as pm
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch_parallel_workers as workers
    r0, r1 = pm.spawn(workers.collectives, 2, ["cuda:0", "cuda:0"], "gloo",
                      timeout_s=300, threads=1)
    for r, rec in enumerate((r0, r1)):
        assert (rec["rank"], rec["size"], rec["backend"], rec["device"]) \
            == (r, 2, "gloo", "cuda:0")
        assert rec["on"] == "cuda:0" * 3
        np.testing.assert_array_equal(rec["sum"], [0.0, 3.0, 6.0])
        np.testing.assert_array_equal(rec["grad"], [2.0, 4.0, 6.0])
        np.testing.assert_array_equal(rec["gather"],
                                      [[0, 0, 1, 1], [0, 0, 1, 1]])
        np.testing.assert_array_equal(rec["fb"], [[0.5] * 4, [1.5] * 4])
        assert rec["fb_dtype"] == "torch.bfloat16"
    np.testing.assert_array_equal(r0["weight"], r1["weight"])
    np.testing.assert_array_equal(r0["moment"], r1["moment"])


def test_parallel_phase_at_a_small_size(gen, tmp_path):
    """chip_smoke's phase 3n on three 26-frame chunks and a corpus of 4
    steps of 16 (latent 16): one NCCL rank bit for bit against no group,
    two gloo ranks on cuda:0 against it, with the launches each rank's
    share predicts, every check passing."""
    fails = chip_smoke.Failures()
    work = chip_smoke.make_work(torch, 0, str(tmp_path), shape=(1, 3, 26))
    launches = chip_smoke.parallel_phase(
        torch, 0, "cuda", fails, "test", work, chunks=3, corpus=(11, 74),
        train_flags=["--latent_dim", "16", "--batch_size", "16"])
    assert fails.items == []
    assert launches["fused_stage_energy"] == 13


def test_gmm_prior_on_the_card_matches_numpy_and_the_cpu(gen, tmp_path):
    """chip_smoke's phase 3p (b) on 64 windows: the GMM score (full and
    diag, K=8, D=450) on the card against float64 numpy (1e-4 relative),
    as gmm_score_fn in total_energy_from_pose against the CPU (relative
    L2 1e-4), and a pickled sklearn fit where sklearn imports."""
    fails = chip_smoke.Failures()
    chip_smoke.gmm_check(torch, 0, "cuda", fails, "test", (str(tmp_path),),
                         n=64)
    assert fails.items == []


def test_camera_energies_on_the_card_match_the_cpu(gen):
    """chip_smoke's phase 3p (c) on 64 windows: reprojection_energy,
    camera_matrix_energy and camera_constraint_energy, values and
    autograd gradients within 1e-5 of the CPU's."""
    fails = chip_smoke.Failures()
    chip_smoke.camera_energies(torch, 0, "cuda", fails, "test", n=64)
    assert fails.items == []


def test_bone_length_vae_on_the_card_matches_the_cpu(gen):
    """chip_smoke's phase 3p (d) at latent 32 and the reference's hidden
    widths: eval encode of 64 windows (1e-4 of the largest), one
    train-mode step at batch 32 (gradients in relative L2, 1e-2; the
    running statistics 1e-5), a bf16 clone's encode finite."""
    fails = chip_smoke.Failures()
    chip_smoke.bone_vae_check(torch, 0, "cuda", fails, "test", latent=32,
                              n=64, batch=32)
    assert fails.items == []
