#!/usr/bin/env python3
"""Start-up proof of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0] [--profile]

Phases (any failure exits non-zero and prints no result line):

1. build    - nvcc builds the four sources of globalegomocap_tpu_torch/csrc/
              for sm_90a, one process each, all started together; prints
              what ptxas reports (registers, spills, smem).
2. kernels  - each kernel against its plain PyTorch version on the same
              CUDA inputs: the fused energies at k=8 bf16 and k=16 f32
              crops, R in {1, 2, 4}, a window count that is a multiple of
              no block size and the serve path's own shapes, and at R=3,
              k=24 and crop coordinates pushed off the crops and onto
              integer cells; the heatmap
              sampler forward and backward on f32 and bf16 64x64 maps,
              points in [-1.3, 1.3], R in {1, 4}, at the shapes of paths A
              and B; the L-BFGS direction at m in {2, 10, 25}, B in {12,
              13, 192}, d = 2048 with partly filled histories, float32
              and bf16 (the solver's bf16 state), and d = 2050 float32
              and d = 36 bf16 (zero-padded to the plan's width); the
              decoder
              energy (kernel 5) with the production prior's conv chain
              (random folded weights), R in {1, 2, 4}, B in {192, 37},
              k=8 bf16 and k=16 f32 crops, and R=4, B=300 (1,200 rows):
              the decoded pose, e, dE/dpose
              (kink points left out and counted, as for kernel 1) and
              dE/dh0 against the plain chain's backward of the kernel's
              own dE/dpose.
3. serve    - 2 sequences x 16 chunks x 100 frames of synthetic data
              (numpy, from --seed) go through the port's `cli/serve.py`
              main at --compute_dtype float32 and the prior's full width (latent 2048, hidden
              64,64,128,256,512) with random priors from a seeded
              torch.Generator.  The kernels' launch counts are reset just
              before and read just after.  Then: one sequence through the
              crop-guard trip path (k=16 crops, robust tier, R=4); one
              warm request's host staging with the native crop and with
              the numpy crop, in turns (the same batch); a serve
              run in which every kernel call is also checked against the
              plain version on its own arguments; and serve runs with the
              plain versions swapped in (metrics and merged poses at 12+3
              iterations, merged poses at 2+1).
3d. path A  - the per-chunk full-map path at the parity CLI's knobs (25/25
              iterations, history 25, 4 step candidates, fused probes
              off): 1 sequence x 4 chunks x 100 frames through the port's
              `cli/optimize_sequence.py` with --solver lbfgs_fixed
              --sampling pallas (the 17-metric summary), then through the
              library `optimize_sequence_dir` with pallas_direction=True,
              the launch counts each run predicts, no failed chunk, a
              shadow run and a plain-version run (metrics within 1 %),
              and the library run at bfloat16_pure (bf16 solver state
              into the direction kernel: its launches, finite metrics,
              and per chunk the projected joints that fell exactly on
              the camera axis beside the chunk's MPJPE at each stage).
3g. path D  - the parity CLI at its own defaults: no --solver flag
              (strong-Wolfe L-BFGS, 25/25 iterations, history 25,
              tolerance_change 1e-6, 25 line-search evaluations) with
              --sampling pallas, on path A's traffic, with both priors
              written as reference .pth.tar training checkpoints: through
              the CLI and `optimize_sequence_dir`, heatmap_sample and its
              backward launched exactly once per batched stage-1 call the
              solver reports and no other kernel, a shadow run, a
              plain-version run (17 metrics within 1 %), one chunk at
              --solver adam.  (Run right after path A.)
3e. path B  - serve's full-map guard fallback: one 16-chunk sequence with
              --sampling pallas --guard_crop 0 and a crop-mass bar no map
              meets; full maps staged, the robust tier, the launch counts
              and a shadow run; then a sequence of two unequal-length
              chunks through serve's per-chunk fallback with the same
              flags (its launch counts, no failed chunk).
3f. path C  - serve's flat solve at the JAX serve's default tier,
              bfloat16_delta: the serve CLI at its default (launch
              counts); the library flat path with serve's config and
              SolverConfig.fused_decode (kernel 5 for stage 1) at
              bfloat16_delta (the main run) and float32, 13 kernel-5 and 0
              kernel-1 launches per request; a k=16 guard trip (16
              kernel-5 launches); a shadow run of every kernel-5 call; a
              plain-version run (17 metrics within 1 %); one request
              timed in turns with kernel 5, without it, and on
              serve-f32-full's float32 stack.
4. timing   - each kernel at its path's shapes (CUDA graph replay, CUDA
              events) beside its bound (from the bytes these inputs need:
              the map and crop sectors that hold an in-range tap, the
              valid history slots), the plain version's time and, for the
              sampler, F.grid_sample's; kernels 1 and 2 at their plan (one
              row a block), beside the record bound (every crop byte, k*k
              cells) too; the launch floor (a no-op kernel) beside
              kernels 1-3; kernel 5 beside its plan (rows a CTA, ring
              stages, the weight bytes its CTAs read from L2), both
              its bounds (float32 on the CUDA cores; 3xTF32 on the
              tensor cores) and both shares, the fused and the unfused
              (cuDNN/cuBLAS decode + kernel 1) stage-1 eval, and at
              1,200 rows; the direction's cluster size C beside each of
              its times.

The last lines are a {"kernels": [...]} record, the card's name and power
limit, and {"ok": true, "device": {...}}.  Needs one CUDA card; exits 2
without one, or when run outside a checkout of the repository.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# published H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, float32 FLOP/s
# outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
# dense TF32 on the tensor cores (the same data sheet)
TF32_FLOP_PER_S = 495e12
# float32 operations the energies do, counted from csrc/fused_energy.cu:
# per crop cell and point (two triangle weights, their derivatives, three
# multiply-adds, the bf16/f32 load), and per point outside the cell loop
# (projection with its partials ~60, the pose-space terms ~60)
OPS_PER_CELL = 14
OPS_PER_POINT_REPROJ = 120
OPS_PER_POINT_POSE = 60
# and since the 2 x 2 tap gather (csrc/energy_core.cuh), per point in place
# of the cell loop: the two axes' taps (~24), four weights and four
# derivatives (~28), four tap addresses (~12), three sums of four terms
# (~36); the record bound `bound` keeps OPS_PER_CELL * k * k
OPS_PER_POINT_TAPS = 100

CSRC = "globalegomocap_tpu_torch/csrc/"
SOURCES = {"fused_stage_energy": CSRC + "fused_energy.cu",
           "fused_stage_energy_noreproj": CSRC + "fused_energy.cu",
           "heatmap_sample": CSRC + "heatmap_sample.cu",
           "heatmap_sample_bwd": CSRC + "heatmap_sample.cu",
           "lbfgs_direction": CSRC + "lbfgs_direction.cu",
           "fused_decode_stage_energy": CSRC + "fused_decode_energy.cu"}
REPLACES = {
    "fused_stage_energy":
        "globalegomocap_tpu/ops/pallas/fused_energy.py:350",
    "fused_stage_energy_noreproj":
        "globalegomocap_tpu/ops/pallas/fused_energy.py:450",
    "heatmap_sample":
        "globalegomocap_tpu/ops/pallas/heatmap_sample.py:97",
    "heatmap_sample_bwd":
        "globalegomocap_tpu/ops/pallas/heatmap_sample.py:128",
    "lbfgs_direction":
        "globalegomocap_tpu/ops/pallas/lbfgs_direction.py:137",
    "fused_decode_stage_energy":
        "globalegomocap_tpu/ops/pallas/fused_decode_energy.py:244",
}
# the production prior's decoder conv chain (hidden 64,64,128,256,512):
# kernel 5's channels, and its float32 operations per (probe, window):
# a k=3 SAME conv over T frames multiplies 3T - 2 taps per (Cin, Cout)
# pair (the edge frames have no outer neighbour), 2 (3T - 2) sum(Cin Cout)
# forward and as much for the input transposes
DEC_DIMS = (512, 256, 128, 64, 64, 64, 45)
DEC_OPS_PER_ROW = 2 * 2 * (3 * 10 - 2) * sum(
    a * b for a, b in zip(DEC_DIMS[:-1], DEC_DIMS[1:]))
# float32 operations per sampled point, counted from
# csrc/heatmap_sample.cu (coordinates, taps, weights, the two pairs)
OPS_PER_SAMPLE = 30
OPS_PER_SAMPLE_BWD = 50
T, J = 10, 15
L = T * J
# the serve traffic: two requests of 16 chunks x 100 frames (192 windows)
SEQUENCES, CHUNKS, FRAMES = 2, 16, 100
# path A traffic: one sequence of 4 chunks x 100 frames (48 windows)
PATH_A_CHUNKS = 4
WINDOWS_PER_CHUNK = 12             # of a 100-frame chunk at stride 8
LATENT = 2048


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


class Failures:
    def __init__(self):
        self.items: list[str] = []

    def check(self, cond: bool, what: str) -> None:
        print(("  ok    " if cond else "  FAIL  ") + what, flush=True)
        if not cond:
            self.items.append(what)


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

# where stage1_inputs puts the crop coordinate of each point, per axis:
# "near" around the crop's middle (+-1 cell); "off" a seventh each around
# the middle, straddling the low edge (-1 <= i < 0) and the high edge
# (k - 1 <= i < k), just off (i ~ -3, ~ k + 2) and far off (i ~ -1000,
# ~ k + 1000) each side; "cells" on integer cells (the edges 0 and k - 1
# among them; exact up to the rounding of ix0 - ox) for probe 0, whose pose
# is then the windows' base pose.
PLACEMENTS = ("near", "off", "cells")


def stage1_inputs(r, b, k, crop_dtype, gen, torch, fe, fisheye,
                  placement="near"):
    """Kernel-layout inputs on the card.  Poses scatter around the
    synthetic skeleton; each window's crop origins put the first probe's
    projection where `placement` says (PLACEMENTS)."""
    from globalegomocap_tpu_torch.ops.skeleton import MEAN3D_MM
    dev = torch.device("cuda")
    base = torch.as_tensor(MEAN3D_MM / 1000.0, dtype=torch.float32,
                           device=dev)                       # (3, 15)
    base = base.repeat(1, T)                                 # (3, L)
    noise = lambda *s: torch.randn(s, generator=gen, device=dev)  # noqa
    p0 = base + 0.05 * noise(b, 3, L)
    pose = (p0[None] + 0.01 * noise(r, b, 3, L)).contiguous()
    anchor = (p0 + 0.02 * noise(b, 3, L)).contiguous()
    cam = fisheye.default_camera("egosyn").to(dev)
    wvec = torch.tensor([[1e-6, 1e-5, 0.01, 0.0, 0.01, 0.0, 0.0, 0.0]],
                        device=dev)
    wvec[0, 5:7] = cam.center
    poly = cam.poly_w2c[None].contiguous()
    s = 63.0 / 1024.0
    ix0, iy0, _ = fe.crop_coordinates(p0[:, 0], p0[:, 1], p0[:, 2], wvec,
                                      poly, s, s, 128.0)
    pick = lambda vals: torch.as_tensor(vals, dtype=torch.float32,  # noqa
                                        device=dev)[torch.randint(
                                            len(vals), (b, L), generator=gen,
                                            device=dev)]
    if placement == "near":
        jitter = lambda: torch.randint(-1, 2, (b, L), generator=gen,  # noqa
                                       device=dev).float()
        ox = torch.floor(ix0) - k // 2 + jitter()
        oy = torch.floor(iy0) - k // 2 + jitter()
    elif placement == "off":
        at = [k // 2, -1, k - 1, -3, k + 2, -1000, k + 1000]
        ox = torch.floor(ix0) - pick(at)
        oy = torch.floor(iy0) - pick(at)
    else:
        pose[0] = p0
        at = list(range(k))
        ox = ix0 - pick(at)
        oy = iy0 - pick(at)
    crops = torch.rand((b, k * k, L), generator=gen, device=dev).to(
        crop_dtype).contiguous()
    bone = (0.1 + 0.4 * torch.rand((b, J), generator=gen, device=dev)
            ).repeat(1, T).contiguous()
    return (pose, anchor, crops, ox.contiguous(), oy.contiguous(), bone,
            wvec, poly, T, J, k, (64, 64), 128.0, 512.0)


def stage2_inputs(r, b, gen, torch):
    dev = torch.device("cuda")
    noise = lambda *s: torch.randn(s, generator=gen, device=dev)  # noqa
    p0 = noise(b, 3, L)
    pose = (p0[None] + 0.05 * noise(r, b, 3, L)).contiguous()
    anchor = (p0 + 0.05 * noise(b, 3, L)).contiguous()
    bone = (0.1 + 0.4 * torch.rand((b, J), generator=gen, device=dev)
            ).repeat(1, T).contiguous()
    wvec = torch.tensor([[0.01, 0.001, 0.01, 0.0, 0.0, 0.0, 0.0, 0.0]],
                        device=dev)
    return pose, anchor, bone, wvec, T, J


def agreement(fe, torch, name, args, e_k, g_k, e_p, g_p, axis_tol=0.0):
    """Kernel outputs (e_k, g_k) against the plain version's (e_p, g_p) on
    the same arguments `args` of `name`.  Returns (ok, max|de|,
    max|dg| over the checked points, max |dg|/(1+|g|), points left out).

    e: rtol 2e-5, atol 1e-5 (the tolerance of tests/test_fused_energy.py).
    g: |dg| <= 1e-4 * (1 + |g_plain|).  The plain version rounds after
    every PyTorch op while nvcc fuses multiply-adds and the kernel sums
    cells and children in its own order; the projection partials
    dP/dx ~ rho/|xy| ~ 1e3 cancel against each other in the reproj term of
    g, so a few float32 ulps of a partial become ~1e-5 of g.  Points whose
    crop coordinate lies within 1e-4 cell of an integer are left out of
    the g check and counted: there the triangle kernel's a.e. derivative
    jumps (by 2 at a cell centre, by 1 at a cell edge), and one ulp of
    difference in the projection picks the other side of the jump.
    With `axis_tol` > 0, points within `axis_tol` m of the camera's axis
    (|xy| <= axis_tol) are left out too: the partials grow as rho/|xy|
    and cancel, and the float32 rounding of g grows with them (a random
    prior decodes some joints that close to the axis).  Kernel 5's checks
    pass 1e-4 (`decode_check`)."""
    smooth = torch.ones_like(g_k, dtype=torch.bool)
    if name == "fused_stage_energy":
        pose, _, _, ox, oy, _, wvec, poly = args[:8]
        (fh, fw), half = args[11], args[13]
        ix, iy, _ = fe.crop_coordinates(
            pose[:, :, 0], pose[:, :, 1], pose[:, :, 2], wvec, poly,
            (fw - 1) / (2.0 * half), (fh - 1) / (2.0 * half), args[12])
        ix, iy = ix - ox, iy - oy
        kink = torch.minimum((ix - ix.round()).abs(),
                             (iy - iy.round()).abs()) <= 1e-4
        if axis_tol > 0:
            kink |= torch.hypot(pose[:, :, 0], pose[:, :, 1]) <= axis_tol
        smooth = (~kink)[:, :, None, :].expand_as(g_k)
    dgs = (g_k - g_p).abs()[smooth]
    gs = g_p.abs()[smooth]
    ok = (bool(torch.isfinite(e_k).all() and torch.isfinite(g_k).all())
          and bool(((e_k - e_p).abs() <= 1e-5 + 2e-5 * e_p.abs()).all())
          and bool(dgs.le(1e-4 * (1 + gs)).all()))
    dg = float(dgs.max()) if dgs.numel() else 0.0
    rel = float((dgs / (1 + gs)).max()) if dgs.numel() else 0.0
    return (ok, float((e_k - e_p).abs().max()), dg, rel,
            int((~smooth).sum()) // 3)


def compare_case(torch, fe, fisheye, name, r, b, k, crop_dtype, gen,
                 placement="near"):
    """One kernel against its plain version on the same CUDA inputs (see
    `agreement`; `placement` as in stage1_inputs).  Returns (ok, message,
    max |error| of e and g)."""
    if name == "fused_stage_energy":
        args = stage1_inputs(r, b, k, crop_dtype, gen, torch, fe, fisheye,
                             placement)
        call = fe.stage_energy_and_grad
        tag = f"k={k} {str(crop_dtype).split('.')[-1]} {placement}"
    else:
        args = stage2_inputs(r, b, gen, torch)
        call = fe.stage_energy_and_grad_noreproj
        tag = "no reproj"
    e_k, g_k = call(*args)
    with fe.plain_versions_on_cuda():
        e_p, g_p = call(*args)
    torch.cuda.synchronize()
    ok, de, dg, rel, n_kink = agreement(fe, torch, name, args, e_k, g_k,
                                        e_p, g_p)
    msg = (f"{name} {tag} R={r} B={b}: max|de|={de:.3e} max|dg|={dg:.3e} "
           f"max|dg|/(1+|g|)={rel:.3e} (|e|~{float(e_p.abs().mean()):.3e}; "
           f"{n_kink} of {r * b * L} points at a kink left out)")
    return ok, msg, max(de, dg)


@contextlib.contextmanager
def shadowed(torch, fe, log):
    """Inside the block every kernel call also runs the plain version on
    the same arguments and appends (name, R, B, agreement(...)) to `log`;
    the kernel's outputs go on.  Counts only the kernel launches."""
    orig = {"fused_stage_energy": fe.stage_energy_and_grad,
            "fused_stage_energy_noreproj": fe.stage_energy_and_grad_noreproj}

    def wrap(name):
        def call(*args):
            e_k, g_k = orig[name](*args)
            with fe.plain_versions_on_cuda():
                e_p, g_p = orig[name](*args)
            log.append((name, tuple(e_k.shape),
                        agreement(fe, torch, name, args, e_k, g_k, e_p,
                                  g_p)))
            return e_k, g_k
        return call

    fe.stage_energy_and_grad = wrap("fused_stage_energy")
    fe.stage_energy_and_grad_noreproj = wrap("fused_stage_energy_noreproj")
    try:
        yield log
    finally:
        fe.stage_energy_and_grad = orig["fused_stage_energy"]
        fe.stage_energy_and_grad_noreproj = orig[
            "fused_stage_energy_noreproj"]


def kernel_phase(torch, fe, fisheye, fails, seed, serve_b):
    """Both kernels against their plain versions: k=8 bf16 and k=16 f32
    crops, R in {1, 2, 4}, B=1037 (a multiple of no block size) and the
    serve batch, plus the guard path's k=16 bf16 at R=4; R=3; k=24; and
    crop coordinates off the crops and on integer cells (`stage1_inputs`
    placements)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    err = {"fused_stage_energy": 0.0, "fused_stage_energy_noreproj": 0.0}
    f32, bf16 = torch.float32, torch.bfloat16
    cases = []
    for b in (1037, serve_b):
        for r in (1, 2, 4):
            cases.append(("fused_stage_energy", r, b, 8, bf16))
            cases.append(("fused_stage_energy", r, b, 16, f32))
            cases.append(("fused_stage_energy_noreproj", r, b, 0, None))
    cases += [("fused_stage_energy", 4, serve_b, 16, bf16),
              ("fused_stage_energy", 3, serve_b, 8, bf16),
              ("fused_stage_energy", 3, 37, 16, f32),
              ("fused_stage_energy_noreproj", 3, serve_b, 0, None),
              ("fused_stage_energy", 2, serve_b, 24, bf16),
              ("fused_stage_energy", 4, 37, 24, f32),
              ("fused_stage_energy", 2, serve_b, 8, bf16, "off"),
              ("fused_stage_energy", 4, 37, 16, f32, "off"),
              ("fused_stage_energy", 1, 37, 24, bf16, "off"),
              ("fused_stage_energy", 2, serve_b, 8, bf16, "cells"),
              ("fused_stage_energy", 3, 37, 16, bf16, "cells"),
              ("fused_stage_energy", 2, 37, 24, f32, "cells")]
    for case in cases:
        ok, msg, e = compare_case(torch, fe, fisheye, *case[:5], gen,
                                  *case[5:])
        fails.check(ok, msg)
        err[case[0]] = max(err[case[0]], e)
    return err


def near_kink(coord, tol=1e-4):
    """Coordinates within `tol` of an integer, where the triangle
    kernel's a.e. derivative jumps."""
    return (coord - coord.round()).abs() <= tol


def sampler_inputs(r, n, dtype, gen, torch, size=64):
    """Maps (n, size, size) in `dtype` and points (r, n, 2) uniform in
    [-1.3, 1.3] on the card."""
    dev = torch.device("cuda")
    maps = torch.rand((n, size, size), generator=gen, device=dev).to(
        dtype).contiguous()
    pts = (torch.rand((r, n, 2), generator=gen, device=dev) * 2.6
           - 1.3).contiguous()
    return maps, pts


def fwd_agreement(torch, out_k, out_p):
    """Sampler forward against the plain version: |d| <= 1e-5 (1 + |p|).
    Returns (ok, max |d|)."""
    d = (out_k - out_p).abs()
    ok = (bool(torch.isfinite(out_k).all())
          and bool((d <= 1e-5 * (1 + out_p.abs())).all()))
    return ok, float(d.max())


def bwd_agreement(torch, maps, pts, d_k, d_p):
    """Sampler backward against the plain version: |d| <= 1e-4 (1 + |p|)
    at the points whose pixel coordinates lie more than 1e-4 from an
    integer; the others are counted and left out.  The kernel computes
    the coordinates with the plain version's own float32 operations (no
    FMA contraction), so it takes the same side of every kink and the
    count is expected to be small.  Returns (ok, max |d|, left out)."""
    h, w = maps.shape[-2], maps.shape[-1]
    kink = (near_kink((pts[..., 0] + 1.0) * (0.5 * (w - 1)))
            | near_kink((pts[..., 1] + 1.0) * (0.5 * (h - 1))))
    smooth = (~kink)[..., None].expand_as(d_k)
    dd = (d_k - d_p).abs()[smooth]
    ok = (bool(torch.isfinite(d_k).all())
          and bool((dd <= 1e-4 * (1 + d_p.abs()[smooth])).all()))
    return ok, float(dd.max()) if dd.numel() else 0.0, int(kink.sum())


def dir_agreement(torch, out_k, out_p):
    """Direction against the plain two-loop, both in the inputs' dtype:
    float32 |d| <= 1e-4 (1 + |p|), both summing 2048-term dot products in
    their own order; bf16 |d| <= 2e-2 (1 + max|p| of the lane), since a
    different sum can move a rounded dot by one of bf16's 8 significand
    bits and that carries through the later steps.  Returns (ok,
    max |d|)."""
    k, p = out_k.float(), out_p.float()
    d = (k - p).abs()
    if out_p.dtype == torch.bfloat16:
        tol = 2e-2 * (1 + p.abs().amax(-1, keepdim=True))
    else:
        tol = 1e-4 * (1 + p.abs())
    ok = (out_k.dtype == out_p.dtype and bool(torch.isfinite(k).all())
          and bool((d <= tol).all()))
    return ok, float(d.max())


def compare_sampler(torch, hs, cb, r, n, dtype, gen):
    """The sampler's forward and backward kernels against the plain
    version on the same CUDA inputs.  Returns (ok, message, max |error|
    forward, backward)."""
    maps, pts = sampler_inputs(r, n, dtype, gen, torch)
    g = torch.randn((r, n), generator=gen, device="cuda")
    out_k = hs.heatmap_sample_fwd(maps, pts)
    d_k = hs.heatmap_sample_bwd(maps, pts, g)
    with cb.plain_versions_on_cuda():
        out_p = hs.heatmap_sample_fwd(maps, pts)
        d_p = hs.heatmap_sample_bwd(maps, pts, g)
    torch.cuda.synchronize()
    ok_f, de = fwd_agreement(torch, out_k, out_p)
    ok_b, dd, n_kink = bwd_agreement(torch, maps, pts, d_k, d_p)
    msg = (f"heatmap_sample fwd+bwd {str(dtype).split('.')[-1]} R={r} "
           f"N={n}: max|dout|={de:.3e} max|ddpts|={dd:.3e} "
           f"(|dpts|~{float(d_p.abs().mean()):.3e}; {n_kink} of {r * n} "
           f"points at a kink left out)")
    return ok_f and ok_b, msg, de, dd


def direction_inputs(b, m, d, gen, torch, dtype=None):
    """Partly filled histories on the card: lane i holds its newest
    fill_i pairs (lane 0 all m, the last lane none), s.y > 0; lane 1 is
    full and its newest pair has y.y = 0 (its rho stays finite), so
    gamma falls back to 1 there.  Made in float32, then cast to `dtype`
    (float32 by default; bf16 as the solver's bf16 state hands them
    over)."""
    dev = torch.device("cuda")
    fill = torch.randint(0, m + 1, (b,), generator=gen, device=dev)
    fill[0], fill[1], fill[-1] = m, m, 0
    valid = (torch.arange(m, device=dev)[None, :]
             >= (m - fill)[:, None]).contiguous()
    mask = valid[..., None].to(torch.float32)
    s = torch.randn((b, m, d), generator=gen, device=dev) * mask
    y = (s * (0.5 + 1.5 * torch.rand((b, m, 1), generator=gen, device=dev))
         + 0.1 * torch.randn((b, m, d), generator=gen, device=dev)) * mask
    rho = torch.where(valid, 1.0 / (s * y).sum(-1).clamp_min(1e-12),
                      torch.zeros((b, m), device=dev)).contiguous()
    y[1, m - 1] = 0.0
    g = torch.randn((b, d), generator=gen, device=dev)
    dtype = dtype or torch.float32
    return (g.to(dtype), s.to(dtype).contiguous(), y.to(dtype).contiguous(),
            rho.to(dtype), valid)


def compare_direction(torch, ld, cb, b, m, gen, dtype=None, d=LATENT):
    """The direction kernel against its plain version; a d whose slices
    are not whole 16-byte rows runs zero-padded to the plan's width."""
    args = direction_inputs(b, m, d, gen, torch, dtype)
    width, p = ld.padded_plan(b, m, d, args[0].dtype, args[0].device)
    out_k = ld.lbfgs_direction(*args)
    with cb.plain_versions_on_cuda():
        out_p = ld.lbfgs_direction(*args)
    torch.cuda.synchronize()
    ok, err = dir_agreement(torch, out_k, out_p)
    msg = (f"lbfgs_direction {str(args[0].dtype).split('.')[-1]} B={b} "
           f"m={m} d={d}" + (f" padded to {width}" if width != d else "")
           + f" (C={p.cluster}, {p.threads} threads, "
           f"{p.smem} B shared memory a CTA): max|dd|={err:.3e} "
           f"(|d|~{float(out_p.float().abs().mean()):.3e}; "
           f"{int(args[4].sum())} of {b * m} slots valid)")
    return ok, msg, err


# sampled points of one chunk's windows (path A) and of one serve batch
# (path B): windows x T x J
PATH_A_POINTS = WINDOWS_PER_CHUNK * L
PATH_B_POINTS = CHUNKS * WINDOWS_PER_CHUNK * L


def new_kernel_phase(torch, hs, ld, cb, fails, seed):
    """The sampler and direction kernels against their plain versions."""
    gen = torch.Generator(device="cuda").manual_seed(seed + 11)
    err = {"heatmap_sample": 0.0, "heatmap_sample_bwd": 0.0,
           "lbfgs_direction": 0.0}
    for dtype in (torch.float32, torch.bfloat16):
        for r in (1, 4):
            for n in (1037, PATH_A_POINTS, PATH_B_POINTS):
                ok, msg, de, dd = compare_sampler(torch, hs, cb, r, n, dtype,
                                                  gen)
                fails.check(ok, msg)
                err["heatmap_sample"] = max(err["heatmap_sample"], de)
                err["heatmap_sample_bwd"] = max(err["heatmap_sample_bwd"],
                                                dd)
    for dtype in (torch.float32, torch.bfloat16):
        for m in (2, 10, 25):
            for b in (12, 13, 192):
                ok, msg, e = compare_direction(torch, ld, cb, b, m, gen,
                                               dtype)
                fails.check(ok, msg)
                err["lbfgs_direction"] = max(err["lbfgs_direction"], e)
    # a latent width whose slices are not whole 16-byte rows (zero-padded)
    for dtype, d in ((torch.float32, 2050), (torch.bfloat16, 36)):
        ok, msg, e = compare_direction(torch, ld, cb, 13, 10, gen, dtype, d)
        fails.check(ok, msg)
        err["lbfgs_direction"] = max(err["lbfgs_direction"], e)
    return err


def decode_inputs(r, b, k, crop_dtype, gen, torch, fe, fde, fisheye):
    """Kernel 5's arguments on the card: the production prior's conv chain
    with random folded weights (unit-gain layers, the last scaled by 0.1
    around the synthetic skeleton), h0 (R, B, T, 512) probes around one
    centre per window, and `stage1_inputs`' context placed around the
    centre's decoded pose."""
    from globalegomocap_tpu_torch.ops.skeleton import MEAN3D_MM
    dev = torch.device("cuda")
    noise = lambda *s: torch.randn(s, generator=gen, device=dev)  # noqa
    layers = []
    for i, (cin, cout) in enumerate(zip(DEC_DIMS[:-1], DEC_DIMS[1:])):
        last = i == len(DEC_DIMS) - 2
        kern = noise(3, cin, cout) * (3 * cin) ** -0.5 * (0.1 if last
                                                          else 1.0)
        bias = (torch.as_tensor(MEAN3D_MM.T.reshape(-1) / 1000.0,
                                dtype=torch.float32, device=dev)
                if last else 0.1 * noise(cout))
        layers.append((kern, bias))
    dl = fde.pack_layers(layers)
    centre = noise(b, T, DEC_DIMS[0])
    h0 = (centre[None] + 0.1 * noise(r, b, T, DEC_DIMS[0])).contiguous()
    p0 = fde.plain_decode_pose(centre[None], dl.layers)[0]     # (B, 3, L)
    anchor = (p0 + 0.02 * noise(b, 3, L)).contiguous()
    cam = fisheye.default_camera("egosyn").to(dev)
    wvec = torch.tensor([[1e-6, 1e-5, 0.01, 0.0, 0.01, 0.0, 0.0, 0.0]],
                        device=dev)
    wvec[0, 5:7] = cam.center
    poly = cam.poly_w2c[None].contiguous()
    s = 63.0 / 1024.0
    ix0, iy0, _ = fe.crop_coordinates(p0[:, 0], p0[:, 1], p0[:, 2], wvec,
                                      poly, s, s, 128.0)
    jitter = lambda: torch.randint(-1, 2, (b, L), generator=gen,  # noqa
                                   device=dev).float()
    ox = (torch.floor(ix0) - k // 2 + jitter()).contiguous()
    oy = (torch.floor(iy0) - k // 2 + jitter()).contiguous()
    crops = torch.rand((b, k * k, L), generator=gen, device=dev).to(
        crop_dtype).contiguous()
    bone = (0.1 + 0.4 * torch.rand((b, J), generator=gen, device=dev)
            ).repeat(1, T).contiguous()
    return (h0, dl, anchor, crops, ox, oy, bone, wvec, poly, T, J, k,
            (64, 64), 128.0, 512.0)


def decode_check(torch, fe, fde, args, out_k):
    """Kernel 5's outputs (e, dE/dh0, pose, dE/dpose) against the plain
    versions on the same arguments, in three parts:

    - the forward chain: the decoded pose, |dp| <= 1e-5 (1 + |p|) (the
      chain sums up to 1536 products per output in another order than
      cuBLAS), and e, |de| <= 1e-5 + 1e-4 |e|;
    - the energy core at the kernel's own pose: `agreement` of kernel 1
      (points within 1e-4 cell of an integer or within 1e-4 m of the
      camera's axis left out of dE/dpose and counted);
    - the backward chain: dE/dh0 against the plain chain's vector-Jacobian
      product with the kernel's own dE/dpose, per row
      |d| / |g| <= 1e-4 (2-norms), so a kink point cannot move it.  The
      LeakyReLU's derivative jumps at 0 too: a row with a hidden
      pre-activation within 1e-5 of its layer's RMS of 0, where the two
      forwards (about 1e-6 of it apart) may take opposite slopes, is left
      out of this part and counted.

    Returns (ok, max |de|, max |d dE/dh0|, worst row, kink points, rows
    left out, the names of the parts that failed)."""
    e_k, gh_k, p_k, g_k = out_k
    h0, dl = args[0], fde.pack_layers(args[1])
    with fde.cuda_build.plain_versions_on_cuda(), torch.enable_grad():
        h = h0.detach().requires_grad_(True)
        pose = fde.plain_decode_pose(h, dl.layers)
        (gh_ref,) = torch.autograd.grad(pose, h, grad_outputs=g_k)
        e_p, _ = fe.stage_energy_and_grad(pose.detach(), *args[2:])
        e_c, g_c = fe.stage_energy_and_grad(p_k, *args[2:])
    pose = pose.detach()
    core = agreement(fe, torch, "fused_stage_energy", (p_k,) + args[2:],
                     e_k, g_k, e_c, g_c, axis_tol=1e-4)
    de = (e_k - e_p).abs()
    rows = ~relu_kink_rows(torch, fde, h0, dl.layers)
    dgh = (gh_k - gh_ref).flatten(2)[rows]
    rel = dgh.norm(dim=-1) / gh_ref.flatten(2)[rows].norm(
        dim=-1).clamp_min(1e-30)
    dp = float(((p_k - pose).abs() / (1 + pose.abs())).max())
    parts = {
        f"energy core (max|de| {core[1]:.3e}, max|dg|/(1+|g|) "
        f"{core[3]:.3e})": core[0],
        "dE/dh0 finite": bool(torch.isfinite(gh_k).all()),
        f"pose (max|dp|/(1+|p|) {dp:.3e})": dp <= 1e-5,
        "e": bool((de <= 1e-5 + 1e-4 * e_p.abs()).all()),
        "dE/dh0": bool((rel <= 1e-4).all())}
    failed = [name for name, good in parts.items() if not good]
    worst = float(rel.max()) if rel.numel() else 0.0
    dmax = float(dgh.abs().max()) if dgh.numel() else 0.0
    return (not failed, float(de.max()), dmax, worst, core[4],
            int((~rows).sum()), failed)


def relu_kink_rows(torch, fde, h0, layers, tol=1e-5):
    """(R, B) rows of h0 with a hidden pre-activation of the plain chain
    within `tol` times its layer's RMS of 0."""
    r, b, t, c0 = h0.shape
    h = h0.reshape(r * b, t, c0)
    near = torch.zeros(r * b, dtype=torch.bool, device=h0.device)
    for kern, bias in layers[:-1]:
        h = fde.conv3(h, kern, bias)
        near |= (h.abs() <= tol * h.square().mean().sqrt()).flatten(
            1).any(1)
        h = h * torch.where(h >= 0.0, 1.0, 0.01)
    return near.reshape(r, b)


def compare_decode(torch, fe, fde, fisheye, r, b, k, crop_dtype, gen):
    args = decode_inputs(r, b, k, crop_dtype, gen, torch, fe, fde, fisheye)
    out_k = fde.decode_energy_and_grad(*args, with_pose=True)
    torch.cuda.synchronize()
    ok, de, dgh, rel, n_kink, n_rows, failed = decode_check(
        torch, fe, fde, args, out_k)
    msg = (f"fused_decode_stage_energy k={k} "
           f"{str(crop_dtype).split('.')[-1]} R={r} B={b}: max|de|={de:.3e} "
           f"max|d dE/dh0|={dgh:.3e} worst row |d|/|g|={rel:.3e} "
           f"(|e|~{float(out_k[0].abs().mean()):.3e}, "
           f"|dE/dh0|~{float(out_k[1].abs().mean()):.3e}; {n_kink} of "
           f"{r * b * L} points at a kink or the camera axis left out of "
           f"dE/dpose, {n_rows} of "
           f"{r * b} rows at a LeakyReLU kink left out of dE/dh0)"
           + (f"; failed: {', '.join(failed)}" if failed else ""))
    return ok, msg, max(de, dgh)


def decode_kernel_phase(torch, fe, fde, fisheye, fails, seed, serve_b):
    """Kernel 5 against its plain version: R in {1, 2, 4}, the serve
    batch and B=37, k=8 bf16 and k=16 f32 crops, and R=4, B=300 at k=8
    bf16 (1,200 rows: more blocks than the card holds at once)."""
    gen = torch.Generator(device="cuda").manual_seed(seed + 17)
    err = 0.0
    cases = [(r, b, k, dtype) for b in (serve_b, 37) for r in (1, 2, 4)
             for k, dtype in ((8, torch.bfloat16), (16, torch.float32))]
    cases.append((4, 300, 8, torch.bfloat16))
    for r, b, k, dtype in cases:
        ok, msg, e = compare_decode(torch, fe, fde, fisheye, r, b, k, dtype,
                                    gen)
        fails.check(ok, msg)
        err = max(err, e)
    return err


@contextlib.contextmanager
def shadowed_decode(torch, fe, fde, log):
    """Inside the block every kernel-5 call also runs `decode_check` on
    its own arguments and appends (name, R, B, check) to `log`; the
    kernel's outputs go on."""
    orig = fde.decode_energy_and_grad

    def call(*args, with_pose=False):
        out = orig(*args, with_pose=True)
        log.append(("fused_decode_stage_energy", tuple(out[0].shape),
                    decode_check(torch, fe, fde, args, out)))
        return out if with_pose else out[:2]

    fde.decode_energy_and_grad = call
    try:
        yield log
    finally:
        fde.decode_energy_and_grad = orig


@contextlib.contextmanager
def shadowed_new(torch, hs, ld, cb, log):
    """Inside the block every sampler and direction kernel call also runs
    the plain version on the same arguments and appends (name,
    agreement) to `log`; the kernel's outputs go on."""
    orig = (hs.heatmap_sample_fwd, hs.heatmap_sample_bwd,
            ld.lbfgs_direction)

    def fwd(maps, pts):
        out = orig[0](maps, pts)
        with cb.plain_versions_on_cuda():
            ref = orig[0](maps, pts)
        log.append(("heatmap_sample", fwd_agreement(torch, out, ref) + (0,)))
        return out

    def bwd(maps, pts, g):
        out = orig[1](maps, pts, g)
        with cb.plain_versions_on_cuda():
            ref = orig[1](maps, pts, g)
        log.append(("heatmap_sample_bwd",
                    bwd_agreement(torch, maps, pts, out, ref)))
        return out

    def direction(*args):
        out = orig[2](*args)
        with cb.plain_versions_on_cuda():
            ref = orig[2](*args)
        log.append(("lbfgs_direction", dir_agreement(torch, out, ref) + (0,)))
        return out

    hs.heatmap_sample_fwd, hs.heatmap_sample_bwd = fwd, bwd
    ld.lbfgs_direction = direction
    try:
        yield log
    finally:
        hs.heatmap_sample_fwd, hs.heatmap_sample_bwd = orig[:2]
        ld.lbfgs_direction = orig[2]


def check_shadow(fails, log, expected, what):
    """Each kernel's shadowed calls: as many as `expected` says, each in
    agreement with the plain version."""
    for name, n in expected.items():
        rows = [a for k, a in log if k == name]
        fails.check(
            len(rows) == n and all(a[0] for a in rows),
            f"{name} on {what}: {len(rows)} calls ({n} expected), each "
            f"against the plain version on its own arguments: max|d|="
            f"{max((a[1] for a in rows), default=0.0):.3e}, "
            f"{sum(a[2] for a in rows)} points at a kink left out")


# ---------------------------------------------------------------------------
# phase 3: the serve path
# ---------------------------------------------------------------------------

def write_sequences(root, n_seq, n_chunks, n_frames, seed):
    from globalegomocap_tpu_torch.data.synthetic import synthetic_chunk
    from globalegomocap_tpu_torch.data.test_data import save_test_chunk
    for s in range(n_seq):
        for c in range(n_chunks):
            chunk = synthetic_chunk(n_frames, seed=seed * 1000 + 100 * s + c)
            start = c * n_frames
            save_test_chunk(chunk, os.path.join(
                root, f"seq{s}", f"data_start_{start}_end_{start + n_frames}"))


def write_priors(root, seed, torch):
    """Random full-width priors (latent 2048) from a seeded generator."""
    from globalegomocap_tpu_torch.config import PriorConfig
    from globalegomocap_tpu_torch.models.conv_vae import ConvVAE, init_random
    p = PriorConfig()
    paths = []
    for name, off in (("local", 1), ("global", 2)):
        gen = torch.Generator().manual_seed(seed * 10 + off)
        model = init_random(ConvVAE(latent_dim=p.latent_dim,
                                    seq_len=p.seq_len,
                                    hidden_dims=p.hidden_dims), gen)
        path = os.path.join(root, f"{name}.pt")
        torch.save(model.state_dict(), path)
        paths.append(path)
    return paths


def run_serve(serve, argv):
    """serve.main(argv) with its JSON lines captured and echoed."""
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        serve.main(argv)
    wall = time.perf_counter() - t0
    recs = [json.loads(line) for line in buf.getvalue().splitlines()
            if line.startswith("{")]
    for rec in recs:
        print("  serve " + json.dumps(rec), flush=True)
    return recs, wall


def path_a_phase(torch, seed, dev, fails, card, work,
                 n_chunks=PATH_A_CHUNKS, n_frames=FRAMES, iters=None,
                 profile=False):
    """Path A: the per-chunk full-map path at the parity CLI's knobs,
    through the CLI and through `optimize_sequence_dir` with the
    direction kernel, with the launch counts reset just before and read
    just after each run; then a shadow run, a plain-version run and a
    library run at bfloat16_pure (bf16 solver state into the kernel).
    `iters` (stage-1 iterations; the CLI default 25 when None) and the
    chunk shape are cut only in a rehearsal on the CPU.  Returns the
    library run's launch counts."""
    from dataclasses import replace
    from globalegomocap_tpu_torch.cli import optimize_sequence as cli
    from globalegomocap_tpu_torch.cli.serve import load_state
    from globalegomocap_tpu_torch.data.test_data import (
        list_chunk_dirs, load_test_chunk)
    from globalegomocap_tpu_torch.evaluation.metrics import METRIC_KEYS
    from globalegomocap_tpu_torch.ops import cuda_build as cb
    from globalegomocap_tpu_torch.ops import fisheye
    from globalegomocap_tpu_torch.ops import heatmap_sample as hs
    from globalegomocap_tpu_torch.ops import lbfgs_direction as ld
    from globalegomocap_tpu_torch.optimize.driver import (
        SequenceOptimizer, build_model, optimize_sequence_dir)
    sync = torch.cuda.synchronize if dev == "cuda" else (lambda: None)
    tmp, _, local_ckpt, global_ckpt = work
    root = os.path.join(tmp, "path_a")
    write_sequences(root, 1, n_chunks, n_frames, seed + 7)
    seq = os.path.join(root, "seq0")
    argv = ["--data_path", seq, "--local_ckpt", local_ckpt, "--global_ckpt",
            global_ckpt, "--solver", "lbfgs_fixed", "--sampling", "pallas",
            "--device", dev]
    if iters is not None:
        argv += ["--max_iter", str(iters)]
    cfg = cli.config_from_args(cli.build_parser().parse_args(argv))
    it1 = cfg.solver.max_iter
    it2 = cfg.solver.global_max_iter or it1
    # per chunk: stage 1 evaluates value-and-grad once, then per iteration
    # one value-only probe call (forward only) and one value-and-grad at
    # the accepted point; the direction runs once per iteration of both
    # stages (stage 2 has no heatmap term)
    expect = {"fused_stage_energy": 0, "fused_stage_energy_noreproj": 0,
              "heatmap_sample": n_chunks * (1 + 2 * it1),
              "heatmap_sample_bwd": n_chunks * (1 + it1),
              "lbfgs_direction": 0, "fused_decode_stage_energy": 0}
    print(f"  {n_chunks} chunks x {n_frames} frames, {it1}+{it2} "
          f"iterations, history {cfg.solver.history_size}, "
          f"{len(cfg.solver.step_candidates)} step candidates, fused "
          f"probes {cfg.solver.fused_probes}", flush=True)

    cb.reset_launches()                        # 1. the CLI
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        cli.main(argv)
    sync()
    wall = time.perf_counter() - t0
    out = buf.getvalue()
    launches = dict(cb.LAUNCHES)
    for line in out.splitlines()[-20:]:
        print("  cli | " + line, flush=True)
    fails.check(out.count("Average ") == 16 and "joints error is:" in out
                and "total optimization time" in out,
                f"optimize_sequence CLI printed the 17-metric summary "
                f"({wall:.2f} s)")
    fails.check("SKIPPED" not in out, "CLI skipped no chunk")
    fails.check(launches == expect, f"CLI launches {launches}, expected "
                f"{expect}")

    cfg = replace(cfg, solver=replace(cfg.solver, pallas_direction=True))
    opt = SequenceOptimizer(build_model(cfg), load_state(local_ckpt),
                            load_state(global_ckpt), cfg, device=dev)
    expect["lbfgs_direction"] = n_chunks * (it1 + it2)
    cb.reset_launches()                        # 2. the library, the main run
    errs, avg, timing = optimize_sequence_dir(opt, seq, verbose=False)
    sync()
    launches = dict(cb.LAUNCHES)
    print(f"  library run with pallas_direction: launches {launches}, "
          f"{timing['per_chunk_s'] * 1e3:.3f} ms per chunk of 12 windows "
          f"[{card}]", flush=True)
    fails.check(timing["failed_chunks"] == [],
                f"no failed chunk ({timing['failed_chunks']})")
    fails.check(launches == expect, f"library launches {launches}, "
                f"expected {expect}")

    log = []                                   # 3. the shadow run
    with shadowed_new(torch, hs, ld, cb, log):
        _, _, t_sh = optimize_sequence_dir(opt, seq, verbose=False)
    fails.check(t_sh["failed_chunks"] == [],
                f"shadow run: no failed chunk ({t_sh['failed_chunks']})")
    check_shadow(fails, log, {k: expect[k] for k in (
        "heatmap_sample", "heatmap_sample_bwd", "lbfgs_direction")},
        "path A")

    with cb.plain_versions_on_cuda():          # 4. the plain versions
        _, pavg, ptiming = optimize_sequence_dir(opt, seq, verbose=False)
    fails.check(ptiming["failed_chunks"] == [], "plain run: no failed chunk")
    worst = max(abs(float(avg[k]) - float(pavg[k])) / abs(float(pavg[k]))
                for k in METRIC_KEYS[:17])
    fails.check(worst <= 0.01,
                f"path A 17 metrics with the kernels vs the plain versions: "
                f"worst relative difference {worst:.3e} (bound 1 %); "
                f"optimized_global_mpjpe {float(avg['optimized_global_mpjpe'])}"
                f" vs {float(pavg['optimized_global_mpjpe'])}; "
                f"{ptiming['per_chunk_s'] * 1e3:.3f} ms per chunk with the "
                f"plain versions")

    # 5. bfloat16_pure: the solver state, and so the direction kernel's
    # inputs, in bf16.  A bf16 decode can put a joint exactly on the
    # camera axis, where the projection's gradient is 0: count such
    # projected joints per chunk, and print each chunk's global MPJPE
    # before, between and after the stages beside the float32 run's
    cfg16 = replace(cfg, compute_dtype="bfloat16_pure")
    opt16 = SequenceOptimizer(build_model(cfg16), load_state(local_ckpt),
                              load_state(global_ckpt), cfg16, device=dev)
    project, run16, on_axis = fisheye.world2camera, opt16.run, []

    def counted(params, pts):
        on_axis[-1] += ((pts[..., 0] == 0) & (pts[..., 1] == 0)).sum()
        return project(params, pts)

    def run(chunk):
        on_axis.append(torch.zeros((), dtype=torch.int64, device=dev))
        return run16(chunk)
    opt16.run, fisheye.world2camera = run, counted
    cb.reset_launches()
    try:
        errs16, avg16, t16 = optimize_sequence_dir(opt16, seq, verbose=False)
    finally:
        fisheye.world2camera = project
        del opt16.run
    sync()
    l16 = dict(cb.LAUNCHES)
    keys = ("original_global_mpjpe", "mid_global_mpjpe",
            "optimized_global_mpjpe")
    for i, (e16, e32) in enumerate(zip(errs16, errs)):
        print(f"  bfloat16_pure chunk {i}: {int(on_axis[i])} projected "
              f"joints on the camera axis; global MPJPE original, mid, "
              f"optimized {[float(e16[k]) for k in keys]} (float32: "
              f"{[float(e32[k]) for k in keys]})", flush=True)
    print(f"  library run at bfloat16_pure with pallas_direction: launches "
          f"{l16}, {t16['per_chunk_s'] * 1e3:.3f} ms per chunk [{card}]",
          flush=True)
    fails.check(t16["failed_chunks"] == [],
                f"bfloat16_pure: no failed chunk ({t16['failed_chunks']})")
    fails.check(l16["lbfgs_direction"] == expect["lbfgs_direction"],
                f"bfloat16_pure: {l16['lbfgs_direction']} direction "
                f"launches, {expect['lbfgs_direction']} expected")
    fails.check(all(abs(float(avg16[k])) < float("inf")
                    for k in METRIC_KEYS[:17]),
                f"bfloat16_pure: the 17 metrics finite "
                f"(optimized_global_mpjpe "
                f"{float(avg16['optimized_global_mpjpe'])})")
    if profile:
        print("[3d'] profile of one path A chunk", flush=True)
        chunk = load_test_chunk(list_chunk_dirs(seq)[0])
        profile_phase(torch, lambda: opt.optimize_chunk(chunk))
    return launches


def write_training_checkpoints(torch, tmp, work):
    """The two priors of `work` as the reference's .pth.tar training
    checkpoints ({'epoch', 'args', 'state_dict', 'eval_result',
    'optimizer'}, an argparse.Namespace under 'args')."""
    paths = []
    for name, path in (("local", work[2]), ("global", work[3])):
        out = os.path.join(tmp, f"{name}.pth.tar")
        torch.save({"epoch": 0,
                    "args": argparse.Namespace(latent_dim=LATENT,
                                               seq_len=T),
                    "state_dict": torch.load(path, weights_only=True),
                    "eval_result": 0.0,
                    "optimizer": {"state": {}, "param_groups": []}}, out)
        paths.append(out)
    return paths


@contextlib.contextmanager
def solver_calls(pipeline, log):
    """Inside the block every per-window solve appends the batched
    objective calls it reports (`LBFGSResult.n_calls`) to `log`: a
    chunk's stage 1, then its stage 2."""
    orig = (pipeline.lbfgs_minimize, pipeline.adam_minimize)

    def recorded(solver):
        def run(*args, **kwargs):
            res = solver(*args, **kwargs)
            log.append(res.n_calls)
            return res
        return run
    pipeline.lbfgs_minimize, pipeline.adam_minimize = map(recorded, orig)
    try:
        yield log
    finally:
        pipeline.lbfgs_minimize, pipeline.adam_minimize = orig


def path_d_phase(torch, seed, dev, fails, card, work,
                 n_chunks=PATH_A_CHUNKS, n_frames=FRAMES, iters=None,
                 profile=False):
    """Path D: the parity CLI at its own defaults (strong-Wolfe L-BFGS,
    25 + 25 iterations, history 25, tolerance_change 1e-6, 25 line-search
    evaluations) with --sampling pallas, on priors written as reference
    .pth.tar training checkpoints, over path A's traffic: through the CLI
    and through `optimize_sequence_dir`, with the launch counts reset just
    before and read just after each run and held against the batched
    stage-1 calls the solver reports; then a shadow run, a plain-version
    run and one chunk at --solver adam.  `iters` and the chunk shape are
    cut only in a rehearsal on the CPU.  Returns the library run's launch
    counts."""
    from dataclasses import replace
    from globalegomocap_tpu_torch.cli import optimize_sequence as cli
    from globalegomocap_tpu_torch.cli.serve import load_state
    from globalegomocap_tpu_torch.data.test_data import (
        list_chunk_dirs, load_test_chunk)
    from globalegomocap_tpu_torch.evaluation.metrics import METRIC_KEYS
    from globalegomocap_tpu_torch.ops import cuda_build as cb
    from globalegomocap_tpu_torch.ops import heatmap_sample as hs
    from globalegomocap_tpu_torch.ops import lbfgs_direction as ld
    from globalegomocap_tpu_torch.optimize import pipeline
    from globalegomocap_tpu_torch.optimize.driver import (
        SequenceOptimizer, build_model, optimize_sequence_dir)
    sync = torch.cuda.synchronize if dev == "cuda" else (lambda: None)
    tmp = work[0]
    root = os.path.join(tmp, "path_d")
    write_sequences(root, 1, n_chunks, n_frames, seed + 7)   # path A's
    seq = os.path.join(root, "seq0")
    local_ckpt, global_ckpt = write_training_checkpoints(torch, root, work)
    argv = ["--data_path", seq, "--local_ckpt", local_ckpt, "--global_ckpt",
            global_ckpt, "--sampling", "pallas", "--device", dev]
    if iters is not None:
        argv += ["--max_iter", str(iters)]
    cfg = cli.config_from_args(cli.build_parser().parse_args(argv))
    s = cfg.solver
    print(f"  {n_chunks} chunks x {n_frames} frames, --solver {s.method}: "
          f"{s.max_iter}+{s.global_max_iter or s.max_iter} iterations, "
          f"history {s.history_size}, tolerance_change "
          f"{s.tolerance_change}, {s.max_ls_evals} line-search "
          f"evaluations", flush=True)
    fails.check(s.method == "lbfgs", f"the CLI's default solver is "
                f"{s.method!r}")

    def expect_of(calls):
        """heatmap_sample and its backward once per batched stage-1
        call (value and gradient at every line-search point), no other
        kernel."""
        stage1 = sum(calls[0::2])
        return {"fused_stage_energy": 0, "fused_stage_energy_noreproj": 0,
                "heatmap_sample": stage1, "heatmap_sample_bwd": stage1,
                "lbfgs_direction": 0, "fused_decode_stage_energy": 0}

    calls = []                                 # 1. the CLI
    cb.reset_launches()
    buf = io.StringIO()
    t0 = time.perf_counter()
    with solver_calls(pipeline, calls), contextlib.redirect_stdout(buf):
        cli.main(argv)
    sync()
    wall = time.perf_counter() - t0
    out = buf.getvalue()
    launches = dict(cb.LAUNCHES)
    for line in out.splitlines()[-20:]:
        print("  cli | " + line, flush=True)
    fails.check(out.count("Average ") == 16 and "joints error is:" in out
                and "total optimization time" in out,
                f"optimize_sequence CLI with no --solver flag printed the "
                f"17-metric summary ({wall:.2f} s)")
    fails.check("SKIPPED" not in out, "CLI skipped no chunk")
    fails.check(len(calls) == 2 * n_chunks and launches == expect_of(calls),
                f"CLI launches {launches}; the solver reported {calls} "
                f"batched calls (stage 1, stage 2 per chunk)")

    model = build_model(cfg)                   # 2. the library, main run
    opt = SequenceOptimizer(model, load_state(local_ckpt, model),
                            load_state(global_ckpt, model), cfg, device=dev)
    calls = []
    cb.reset_launches()
    with solver_calls(pipeline, calls):
        errs, avg, timing = optimize_sequence_dir(opt, seq, verbose=False)
    sync()
    launches = main_launches = dict(cb.LAUNCHES)
    print(f"  library run: launches {launches}; batched calls per stage "
          f"{calls}; {timing['per_chunk_s'] * 1e3:.3f} ms per chunk of 12 "
          f"windows [{card}]", flush=True)
    fails.check(timing["failed_chunks"] == [],
                f"no failed chunk ({timing['failed_chunks']})")
    fails.check(len(calls) == 2 * n_chunks and launches == expect_of(calls),
                f"library launches {launches}, expected "
                f"{expect_of(calls)}")

    log, sh_calls = [], []                     # 3. the shadow run
    with shadowed_new(torch, hs, ld, cb, log), solver_calls(pipeline,
                                                             sh_calls):
        _, _, t_sh = optimize_sequence_dir(opt, seq, verbose=False)
    fails.check(t_sh["failed_chunks"] == [],
                f"shadow run: no failed chunk ({t_sh['failed_chunks']})")
    check_shadow(fails, log, {k: v for k, v in expect_of(sh_calls).items()
                              if k in ("heatmap_sample",
                                       "heatmap_sample_bwd",
                                       "lbfgs_direction")}, "path D")

    with cb.plain_versions_on_cuda():          # 4. the plain versions
        _, pavg, ptiming = optimize_sequence_dir(opt, seq, verbose=False)
    fails.check(ptiming["failed_chunks"] == [], "plain run: no failed chunk")
    worst = max(abs(float(avg[k]) - float(pavg[k])) / abs(float(pavg[k]))
                for k in METRIC_KEYS[:17])
    fails.check(worst <= 0.01,
                f"path D 17 metrics with the kernels vs the plain versions: "
                f"worst relative difference {worst:.3e} (bound 1 %); "
                f"optimized_global_mpjpe {float(avg['optimized_global_mpjpe'])}"
                f" vs {float(pavg['optimized_global_mpjpe'])}; "
                f"{ptiming['per_chunk_s'] * 1e3:.3f} ms per chunk with the "
                f"plain versions")

    # 5. one chunk at --solver adam: 150 steps a stage, steps + 1 calls
    cfg_a = replace(cfg, solver=replace(s, method="adam"))
    opt_a = SequenceOptimizer(model, load_state(local_ckpt, model),
                              load_state(global_ckpt, model), cfg_a,
                              device=dev)
    chunk = load_test_chunk(list_chunk_dirs(seq)[0])
    calls = []
    cb.reset_launches()
    t0 = time.perf_counter()
    with solver_calls(pipeline, calls):
        errs_a, *_ = opt_a.run(chunk)
    sync()
    wall = time.perf_counter() - t0
    launches = dict(cb.LAUNCHES)
    fails.check(calls == [s.adam_steps + 1] * 2
                and launches == expect_of(calls),
                f"adam: launches {launches}, batched calls {calls}, "
                f"{wall * 1e3:.3f} ms for the chunk [{card}]")
    fails.check(all(abs(float(errs_a[k])) < float("inf")
                    for k in METRIC_KEYS[:17]),
                f"adam: the 17 metrics finite (optimized_global_mpjpe "
                f"{float(errs_a['optimized_global_mpjpe'])})")
    if profile:
        print("[3g'] profile of one path D chunk", flush=True)
        profile_phase(torch, lambda: opt.optimize_chunk(chunk))
    return main_launches


def path_b_phase(torch, dev, fails, card, work,
                 shape=(CHUNKS, FRAMES), profile=False):
    """Path B: serve's full-map guard fallback on the first sequence of
    the serve traffic, the guard tripped through the CLI (--guard_crop 0
    and a crop-mass bar of 1.1, which no map meets).  Returns the launch
    counts of the run."""
    from globalegomocap_tpu_torch.cli import serve
    from globalegomocap_tpu_torch.data.test_data import (
        list_chunk_dirs, load_test_chunk)
    from globalegomocap_tpu_torch.ops import cuda_build as cb
    from globalegomocap_tpu_torch.ops import fused_energy as fe
    from globalegomocap_tpu_torch.ops import heatmap_sample as hs
    from globalegomocap_tpu_torch.ops import lbfgs_direction as ld
    from globalegomocap_tpu_torch.optimize.driver import (
        SequenceOptimizer, build_model)
    n_chunks, n_frames = shape
    tmp, data, local_ckpt, global_ckpt = work
    base = ["--data_root", data, "--local_ckpt", local_ckpt, "--global_ckpt",
            global_ckpt, "--device", dev, "--compute_dtype", "float32",
            "--sampling", "pallas", "--guard_crop", "0",
            "--heatmap_crop_min_mass", "1.1", "--max_batches", "1"]
    cfg = serve.config_from_args(serve.build_parser().parse_args(base))
    opt = SequenceOptimizer(build_model(cfg), serve.load_state(local_ckpt),
                            serve.load_state(global_ckpt), cfg, device=dev)
    chunks = [load_test_chunk(d) for d in list_chunk_dirs(
        os.path.join(data, "seq0"))]
    t0 = time.perf_counter()
    staged = opt.stage(chunks, on_host=True)
    t_stage = time.perf_counter() - t0
    print(f"  path B host staging of 16 chunks of full maps (numpy guard "
          f"pass, stack, bf16 cast, copy to the card): "
          f"{t_stage * 1e3:.3f} ms [{card}]", flush=True)
    eff = opt._cfg_for_coverage(staged.crop_coverage)
    fails.check(staged.origins is None and eff.heatmap_crop == 0
                and tuple(staged.heat.shape) == (n_chunks, n_frames, 64, 64,
                                                 J)
                and staged.heat.dtype == torch.bfloat16,
                f"guard tripped at coverage {staged.crop_coverage:.4f}: full "
                f"maps staged {tuple(staged.heat.shape)} "
                f"{str(staged.heat.dtype).split('.')[-1]}")
    s = eff.solver
    fails.check((s.max_iter, s.history_size, len(s.step_candidates))
                == (15, 10, 4), f"robust tier: {s.max_iter} iterations, "
                f"history {s.history_size}, {len(s.step_candidates)} step "
                f"candidates")
    if profile:
        print("[3e'] profile of one path B solve", flush=True)
        profile_phase(torch, lambda: opt.optimize_chunks_batched(
            staged, mode="flat"))
    del staged
    # fused probes: one value-and-grad per evaluation, 1 + iterations
    expect = {"fused_stage_energy": 0,
              "fused_stage_energy_noreproj": 1 + s.global_max_iter,
              "heatmap_sample": 1 + s.max_iter,
              "heatmap_sample_bwd": 1 + s.max_iter, "lbfgs_direction": 0,
              "fused_decode_stage_energy": 0}
    cb.reset_launches()
    recs, wall = run_serve(serve, base)
    launches = dict(cb.LAUNCHES)
    fails.check(len(recs) == 1 and "error" not in recs[0]
                and "windows_per_sec" in recs[0],
                f"path B serve line emitted ({wall:.2f} s) [{card}]")
    fails.check(launches == expect, f"path B launches {launches}, "
                f"expected {expect}")
    log_fe, log_new = [], []
    with shadowed(torch, fe, log_fe), shadowed_new(torch, hs, ld, cb,
                                                   log_new):
        run_serve(serve, base)
    check_shadow(fails, log_new, {"heatmap_sample": expect["heatmap_sample"],
                                  "heatmap_sample_bwd":
                                      expect["heatmap_sample_bwd"]},
                 "path B")
    rows = [a for n, _, a in log_fe if n == "fused_stage_energy_noreproj"]
    fails.check(len(rows) == expect["fused_stage_energy_noreproj"]
                and all(a[0] for a in rows),
                f"fused_stage_energy_noreproj on path B: {len(rows)} calls, "
                f"each against the plain version")

    # serve's unequal-length fallback with the same flags: a sequence of
    # an n_frames and an (n_frames - 10)-frame chunk goes chunk by chunk
    # through optimize_sequence_dir, each chunk's guard trips on its raw
    # maps and its full maps are solved as above; a chunk that failed
    # (a failed launch, say) would turn the line into an error record
    from globalegomocap_tpu_torch.data.synthetic import synthetic_chunk
    from globalegomocap_tpu_torch.data.test_data import save_test_chunk
    mixed = os.path.join(tmp, "path_b_mixed")
    start = 0
    for c, n in enumerate((n_frames, n_frames - 10)):
        save_test_chunk(synthetic_chunk(n, seed=9000 + c), os.path.join(
            mixed, "seqM", f"data_start_{start}_end_{start + n}"))
        start += n
    expect = {k: 2 * v for k, v in expect.items()}
    cb.reset_launches()
    recs, wall = run_serve(serve, ["--data_root", mixed] + base[2:])
    mixed_launches = dict(cb.LAUNCHES)
    fails.check(len(recs) == 1 and "error" not in recs[0]
                and recs[0].get("chunks") == 2,
                f"path B unequal-length sequence: serve line emitted, no "
                f"chunk failed ({wall:.2f} s) [{card}]")
    fails.check(mixed_launches == expect, f"path B unequal-length launches "
                f"{mixed_launches}, expected {expect}")
    return launches


def mean_metrics(results, calculate_errors, keys):
    """The 17 metrics averaged over every chunk of `results` (ChunkResults
    with a leading chunk axis)."""
    per = [calculate_errors(r.estimated, r.mid, r.optimized, r.gt)
           for r in results]
    return {k: float(sum(float(p[k].sum()) for p in per)
                     / sum(p[k].numel() for p in per)) for k in keys}


def path_c_phase(torch, dev, fails, card, work,
                 shape=(SEQUENCES, CHUNKS, FRAMES), profile=False):
    """Path C: serve's flat solve at the JAX serve's default tier
    (bfloat16_delta), stage 1 through kernel 5 (SolverConfig.fused_decode,
    which no CLI flag sets: the library path, as scripts/fused_ab.py
    reaches it).  The launch counts are reset just before and read just
    after each run.  Returns the main run's launch counts (the library
    path at bfloat16_delta over the serve traffic)."""
    from dataclasses import replace
    from globalegomocap_tpu_torch.cli import serve
    from globalegomocap_tpu_torch.data.test_data import (
        list_chunk_dirs, load_test_chunk)
    from globalegomocap_tpu_torch.evaluation.metrics import (
        METRIC_KEYS, calculate_errors)
    from globalegomocap_tpu_torch.ops import cuda_build as cb
    from globalegomocap_tpu_torch.ops import fused_energy as fe
    from globalegomocap_tpu_torch.ops import fused_decode_energy as fde
    from globalegomocap_tpu_torch.optimize.driver import (
        SequenceOptimizer, build_model)
    n_seq = shape[0]
    sync = torch.cuda.synchronize if dev == "cuda" else (lambda: None)
    tmp, data, local_ckpt, global_ckpt = work
    base = ["--data_root", data, "--local_ckpt", local_ckpt, "--global_ckpt",
            global_ckpt, "--device", dev]
    cfg = serve.config_from_args(serve.build_parser().parse_args(base))
    it1, it2 = cfg.solver.max_iter, cfg.solver.global_max_iter
    zero = {name: 0 for name in cb.LAUNCHES}

    cb.reset_launches()                        # 1. the serve CLI's default
    recs, wall = run_serve(serve, base)
    launches = dict(cb.LAUNCHES)
    fails.check(cfg.compute_dtype == "bfloat16_delta" and len(recs) == n_seq
                and all("error" not in r for r in recs),
                f"serve at its default tier {cfg.compute_dtype}: {len(recs)}"
                f" of {n_seq} sequences answered ({wall:.2f} s) [{card}]")
    expect = dict(zero, fused_stage_energy=n_seq * (1 + it1),
                  fused_stage_energy_noreproj=n_seq * (1 + it2))
    fails.check(launches == expect, f"serve default-tier launches "
                f"{launches}, expected {expect}")

    def optimizer(tier, fused_decode=True):
        c = replace(cfg, compute_dtype=tier, solver=replace(
            cfg.solver, fused_decode=fused_decode))
        return SequenceOptimizer(build_model(c), serve.load_state(local_ckpt),
                                 serve.load_state(global_ckpt), c,
                                 device=dev)

    opt = optimizer("bfloat16_delta")
    seqs = [os.path.join(data, n) for n in sorted(os.listdir(data))]
    requests = [[load_test_chunk(d) for d in list_chunk_dirs(q)]
                for q in seqs]
    staged = [opt.stage(chunks, on_host=True) for chunks in requests]

    def solve(o, batches=staged):
        t0 = time.perf_counter()
        out = [o.optimize_chunks_batched(b, mode="flat") for b in batches]
        sync()
        return out, time.perf_counter() - t0

    per_req = dict(zero, fused_decode_stage_energy=1 + it1,
                   fused_stage_energy_noreproj=1 + it2)
    expect = {k: n_seq * v for k, v in per_req.items()}
    cb.reset_launches()                        # 2. the main run
    res_main, t_main = solve(opt)
    main_launches = dict(cb.LAUNCHES)
    fails.check(main_launches == expect,
                f"path C bfloat16_delta launches {main_launches}, expected "
                f"{expect} ({t_main * 1e3:.3f} ms for {n_seq} requests) "
                f"[{card}]")
    fails.check(all(bool(torch.isfinite(x).all()) and x.dtype ==
                    torch.float32 for r in res_main for x in r),
                "path C bfloat16_delta outputs finite float32")
    opt32 = optimizer("float32")
    cb.reset_launches()
    res32, t32 = solve(opt32)
    fails.check(dict(cb.LAUNCHES) == expect,
                f"path C float32 launches {dict(cb.LAUNCHES)}, expected "
                f"{expect} ({t32 * 1e3:.3f} ms) [{card}]")

    guard = opt.stage(requests[0], on_host=True, coverage=0.1)  # 3. guard
    robust = opt._cfg_for_coverage(0.1).solver
    cb.reset_launches()
    res_g = opt.optimize_chunks_batched(guard, mode="flat")
    sync()
    g_expect = dict(zero, fused_decode_stage_energy=1 + robust.max_iter,
                    fused_stage_energy_noreproj=1 + robust.global_max_iter)
    fails.check(guard.heat.shape[-1] == 16 * 16 * J
                and dict(cb.LAUNCHES) == g_expect
                and all(bool(torch.isfinite(x).all()) for x in res_g),
                f"path C guard trip (k=16 crops, robust tier): launches "
                f"{dict(cb.LAUNCHES)}, expected {g_expect}; outputs finite")
    del guard

    log = []                                   # 4. the shadow run
    with shadowed_decode(torch, fe, fde, log):
        solve(opt)
    rows = [a for _, _, a in log]
    fails.check(len(rows) == expect["fused_decode_stage_energy"]
                and all(a[0] for a in rows),
                f"fused_decode_stage_energy on path C: {len(rows)} calls "
                f"({expect['fused_decode_stage_energy']} expected), each "
                f"against the plain versions on its own arguments: "
                f"max|de|={max((a[1] for a in rows), default=0.0):.3e} "
                f"max|d dE/dh0|={max((a[2] for a in rows), default=0.0):.3e}"
                f" worst row {max((a[3] for a in rows), default=0.0):.3e}, "
                f"{sum(a[4] for a in rows)} points at a kink or the camera "
                f"axis left out of dE/dpose, {sum(a[5] for a in rows)} rows "
                f"at a LeakyReLU kink left out of dE/dh0"
                + "".join(f"; call {i} failed: {', '.join(a[6])}"
                          for i, a in enumerate(rows) if a[6]))

    with cb.plain_versions_on_cuda():          # 5. the plain versions
        res_plain, t_plain = solve(opt)
    keys = METRIC_KEYS[:17]
    m_k = mean_metrics(res_main, calculate_errors, keys)
    m_p = mean_metrics(res_plain, calculate_errors, keys)
    worst = max((abs(m_k[k] - m_p[k]) / abs(m_p[k]), k) for k in keys)
    fails.check(worst[0] <= 0.01,
                f"path C 17 metrics (mean over {n_seq * shape[1]} chunks) "
                f"with the kernels vs the plain versions: worst relative "
                f"difference {worst[0]:.3e} ({worst[1]}; bound 1 %); "
                f"optimized_global_mpjpe {m_k['optimized_global_mpjpe']} vs "
                f"{m_p['optimized_global_mpjpe']}; plain versions "
                f"{t_plain * 1e3:.3f} ms")

    # 6. in turns: with kernel 5, without it (bf16 cuDNN/cuBLAS decode +
    # kernel 1), and serve-f32-full's float32 stack on the same request
    ways = {"with kernel 5": opt,
            "without (bf16 cuDNN/cuBLAS decode + kernel 1)":
                optimizer("bfloat16_delta", fused_decode=False),
            "float32 without": optimizer("float32", fused_decode=False)}
    one = staged[:1]
    times = {name: [] for name in ways}
    for turn in (0, 1, 2, 2, 1, 0, 0, 1, 2):
        name = list(ways)[turn]
        times[name].append(solve(ways[name], one)[1] * 1e3)
    print(f"  path C one warm request of {staged[0].est.shape[0]} chunks, "
          f"solve ms in turns: bfloat16_delta "
          + "; ".join(f"{name} " + "/".join(f"{t:.3f}" for t in ts)
                      for name, ts in times.items())
          + f" [{card}]", flush=True)
    if profile:
        for name, o in ways.items():
            print(f"[3f'] profile of one path C solve, {name}", flush=True)
            profile_phase(torch, lambda: o.optimize_chunks_batched(
                staged[0], mode="flat"))
    return main_launches


# ---------------------------------------------------------------------------
# phase 4: timing
# ---------------------------------------------------------------------------

def graph_ms(torch, fn, per_graph=20, reps=25):
    """Device time of one call: `per_graph` calls captured in a CUDA graph,
    replayed `reps` times between CUDA events (no host launch cost)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(per_graph):
            fn()
    g.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        g.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (reps * per_graph)


def event_ms(torch, fn, reps=20):
    """Time of one call between CUDA events, host launch cost included."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound_of(nbytes, ops):
    """(bound_ms, 'bytes' | 'operations'): the larger of the bytes over
    the HBM rate and the float32 operations over the float32 peak."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def sampler_map_bytes(torch, maps, pts):
    """Bytes of map the sampler must read for these points: the distinct
    32-byte sectors that hold at least one in-range tap (columns
    floor(ix), floor(ix) + 1 and rows likewise, as csrc/heatmap_sample.cu
    reads them; a tap outside the map is never read).  A sector shared by
    several points or probe rows counts once."""
    n, h, w = maps.shape
    e = maps.element_size()
    ix = ((pts[..., 0] + 1.0) * (0.5 * (w - 1))).floor().long()
    iy = ((pts[..., 1] + 1.0) * (0.5 * (h - 1))).floor().long()
    mapid = torch.arange(n, device=pts.device).expand_as(ix)
    sectors = []
    for dy in (0, 1):
        for dx in (0, 1):
            y, x = iy + dy, ix + dx
            ok = (y >= 0) & (y < h) & (x >= 0) & (x < w)
            sectors.append((((mapid * h + y) * w + x) * e // 32)[ok])
    return 32 * int(torch.unique(torch.cat(sectors)).numel())


def direction_bound(b, m, d, n_valid, elem=4):
    """The two-loop recursion's bound on these histories of `elem`-byte
    elements: the gradient in and the direction out, rho and valid of
    every slot, and s and y of the `n_valid` valid slots only (the kernel
    skips the others in both loops); a dot product and an axpy per valid
    slot in each loop."""
    nbytes = (b * 2 * d * elem + b * m * (elem + 1)
              + n_valid * 2 * d * elem)
    return bound_of(nbytes, 8 * n_valid * d + 3 * b * d)


def bound(name, r, b, k, crop_bytes):
    """(bound_ms, 'bytes' | 'operations') from the call's shapes: each
    input read once, each output written once; the operations counted
    above over the float32 peak.  The record of the dense k*k cell sum
    (every crop byte, OPS_PER_CELL * k * k a point), kept beside
    `tap_bound` so the shares of earlier PRs stay comparable."""
    pose_io = r * b * (3 * L * 4 * 2 + 4)          # pose in, g out, e out
    if name == "fused_stage_energy":
        ctx = b * (3 * L * 4 + k * k * L * crop_bytes + 3 * L * 4)
        ops = r * b * L * (OPS_PER_CELL * k * k + OPS_PER_POINT_REPROJ)
    else:
        ctx = b * (3 * L * 4 + L * 4)
        ops = r * b * L * OPS_PER_POINT_POSE
    return bound_of(pose_io + ctx, ops)


def crop_tap_bytes(torch, fe, args):
    """Bytes of crop the stage-1 kernel must read for these arguments: the
    distinct 32-byte sectors of the (B, k*k, L) crops that hold at least
    one in-range tap of a point of any probe row (columns floor(ix) and
    floor(ix) + 1, rows likewise, as csrc/energy_core.cuh reads them; a
    tap outside the crop is never read), counted as `sampler_map_bytes`
    counts the sampler's.  The coordinates are the plain version's."""
    pose, _, crops, ox, oy, _, wvec, poly = args[:8]
    k, (fh, fw), offset, half = args[10:14]
    ix, iy, _ = fe.crop_coordinates(
        pose[:, :, 0], pose[:, :, 1], pose[:, :, 2], wvec, poly,
        (fw - 1) / (2.0 * half), (fh - 1) / (2.0 * half), offset)
    x0, y0 = (ix - ox).floor(), (iy - oy).floor()          # (R, B, L)
    b = crops.shape[0]
    win = torch.arange(b, device=pose.device)[None, :, None]
    pt = torch.arange(L, device=pose.device)
    e = crops.element_size()
    sectors = []
    for dy in (0, 1):
        for dx in (0, 1):
            y, x = y0 + dy, x0 + dx
            ok = (y >= 0) & (y <= k - 1) & (x >= 0) & (x <= k - 1)  # NaN
            cell = torch.where(ok, y * k + x, 0).long()
            sectors.append((((win * k * k + cell) * L + pt) * e // 32)[ok])
    return 32 * int(torch.unique(torch.cat(sectors)).numel())


def tap_bound(torch, fe, name, args):
    """(bound_ms, 'bytes' | 'operations', crop bytes) of one call of the
    tap kernel on these arguments: the pose in, g and e out, the window
    context (anchor, ox, oy, bone; anchor and bone without reprojection)
    read once, the crop sectors `crop_tap_bytes` counts, and
    OPS_PER_POINT_REPROJ + OPS_PER_POINT_TAPS (or OPS_PER_POINT_POSE)
    operations a point."""
    r, b = args[0].shape[:2]
    pose_io = r * b * (3 * L * 4 * 2 + 4)
    if name == "fused_stage_energy":
        crop = crop_tap_bytes(torch, fe, args)
        nbytes = pose_io + b * 6 * L * 4 + crop
        ops = r * b * L * (OPS_PER_POINT_REPROJ + OPS_PER_POINT_TAPS)
    else:
        crop = 0
        nbytes = pose_io + b * 4 * L * 4
        ops = r * b * L * OPS_PER_POINT_POSE
    return bound_of(nbytes, ops) + (crop,)


def timing_new(torch, hs, ld, cb, seed, card):
    """The sampler at the path A (R=4 probes over one chunk's 1800 f32
    maps) and path B (R=4 over a serve batch's 28800 bf16 maps) shapes
    beside F.grid_sample on the same points (float32 maps of shape
    (N, 1, 64, 64), grid (N, 1, R, 2): the library yardstick, never
    called by the port), and the direction at path A's (12 lanes, m=25,
    float32 and bf16) and the kernel phase's B=192 shapes, each at the
    cluster size `plan` takes.  Each bound counts the bytes these inputs need
    (`sampler_map_bytes`, `direction_bound`).  Returns {name: (ms,
    plain_ms, bound_ms, bound_by, library_ms)} at path A's shapes."""
    F = torch.nn.functional
    gen = torch.Generator(device="cuda").manual_seed(seed + 13)
    rows = {}
    for tag, r, n, dtype in (("path A", 4, PATH_A_POINTS, torch.float32),
                             ("path B", 4, PATH_B_POINTS, torch.bfloat16)):
        maps, pts = sampler_inputs(r, n, dtype, gen, torch)
        g = torch.randn((r, n), generator=gen, device="cuda")
        inp = maps.to(torch.float32)[:, None].contiguous()
        grid = pts.permute(1, 0, 2)[:, None].contiguous()
        go = g.t()[:, None, None, :].contiguous()
        map_bytes = sampler_map_bytes(torch, maps, pts)
        calls = {
            "heatmap_sample": (
                lambda: hs.heatmap_sample_fwd(maps, pts),
                lambda: F.grid_sample(inp, grid, mode="bilinear",
                                      padding_mode="zeros",
                                      align_corners=True),
                r * n * (8 + 4) + map_bytes, r * n * OPS_PER_SAMPLE),
            "heatmap_sample_bwd": (
                lambda: hs.heatmap_sample_bwd(maps, pts, g),
                lambda: torch.ops.aten.grid_sampler_2d_backward(
                    go, inp, grid, 0, 0, True, [False, True]),
                r * n * (8 + 4 + 8) + map_bytes,
                r * n * OPS_PER_SAMPLE_BWD)}
        print(f"  {tag}: {map_bytes} bytes of map needed by {r * n} points "
              f"({map_bytes / (r * n):.2f} per point)", flush=True)
        for name, (fn, lib, nbytes, ops) in calls.items():
            ms = graph_ms(torch, fn)
            lib_ms = graph_ms(torch, lib)
            with cb.plain_versions_on_cuda():
                plain = event_ms(torch, fn)
            bms, by = bound_of(nbytes, ops)
            print(f"  time  {name} {tag} R={r} N={n} "
                  f"{str(dtype).split('.')[-1]} maps: kernel {ms:.6f} ms, "
                  f"bound {bms:.6f} ms ({by}), roofline share "
                  f"{bms / ms:.4f}, plain version {plain:.6f} ms, "
                  f"F.grid_sample{'' if name == 'heatmap_sample' else ' backward'}"
                  f" {lib_ms:.6f} ms [{card}]", flush=True)
            rows.setdefault(name, (ms, plain, bms, by, lib_ms))
    f32, bf16 = torch.float32, torch.bfloat16
    for b, m, dtype in ((WINDOWS_PER_CHUNK, 25, f32), (192, 10, f32),
                        (192, 2, f32), (WINDOWS_PER_CHUNK, 25, bf16)):
        args = direction_inputs(b, m, LATENT, gen, torch, dtype)
        p = ld.plan(b, m, LATENT, dtype, args[0].device)
        fn = lambda: ld.lbfgs_direction(*args)  # noqa: E731
        ms = graph_ms(torch, fn)
        with cb.plain_versions_on_cuda():
            plain = event_ms(torch, fn)
        n_valid = int(args[4].sum())
        bms, by = direction_bound(b, m, LATENT, n_valid,
                                  args[0].element_size())
        print(f"  time  lbfgs_direction {str(dtype).split('.')[-1]} B={b} "
              f"m={m} d={LATENT} ({n_valid} of {b * m} slots valid), "
              f"C={p.cluster} ({p.threads} threads, {p.smem} B shared "
              f"memory a CTA): kernel {ms:.6f} ms, bound {bms:.6f} ms "
              f"({by}), roofline share {bms / ms:.4f}, plain version "
              f"{plain:.6f} ms [{card}]", flush=True)
        rows.setdefault("lbfgs_direction", (ms, plain, bms, by, None))
    return rows


def timing_phase(torch, fe, fisheye, seed, b, card):
    """Kernels 1 and 2 at the paths' shapes: the time at their plan (one
    row a block), both bounds (the record `bound`, every crop byte and k*k
    cells; `tap_bound`, what the taps need) and both shares, and the plain
    version.  Returns {name:
    (ms, plain_ms, bound_ms, bound_by, tag)} at each kernel's first shape,
    its bound the tap bound."""
    gen = torch.Generator(device="cuda").manual_seed(seed + 7)
    rows = {}
    shapes = [("fused_stage_energy", 2, b, 8, torch.bfloat16),
              ("fused_stage_energy", 1, b, 8, torch.bfloat16),
              ("fused_stage_energy", 4, b, 16, torch.bfloat16),
              ("fused_stage_energy_noreproj", 2, b, 0, None),
              ("fused_stage_energy_noreproj", 1, b, 0, None),
              ("fused_stage_energy", 2, 3840, 8, torch.bfloat16),
              ("fused_stage_energy_noreproj", 2, 3840, 0, None)]
    for name, r, bb, k, cdt in shapes:
        if name == "fused_stage_energy":
            args = stage1_inputs(r, bb, k, cdt, gen, torch, fe, fisheye)
            call = lambda: fe.stage_energy_and_grad(*args)  # noqa: E731
            cb = 2 if cdt == torch.bfloat16 else 4
        else:
            args = stage2_inputs(r, bb, gen, torch)
            call = lambda: fe.stage_energy_and_grad_noreproj(*args)  # noqa
            cb = 0
        p = fe.plan(r, bb, L)
        ms = graph_ms(torch, call)
        with fe.plain_versions_on_cuda():
            plain = event_ms(torch, call)
        bms, by = bound(name, r, bb, k, cb)
        tms, tby, crop = tap_bound(torch, fe, name, args)
        tag = f"{name} R={r} B={bb}" + (f" k={k}" if k else "")
        print(f"  time  {tag}: kernel {ms:.6f} ms at the plan's one row a "
              f"block ({p.blocks} blocks of {p.threads} threads); tap "
              f"bound {tms:.6f} ms ({tby}; {crop} bytes of crop sectors), "
              f"share {tms / ms:.4f}; record bound {bms:.6f} ms ({by}), "
              f"share {bms / ms:.4f}; plain version {plain:.6f} ms (no "
              f"yardstick) [{card}]", flush=True)
        rows.setdefault(name, (ms, plain, tms, tby, tag))
    return rows


def launch_floor(torch, fe, card, rows):
    """The no-op kernel's time (one block of one thread, CUDA graph
    replay, as every kernel here is timed) beside kernel 2 and kernel 3
    at their timed shapes: what separates a small kernel from its bound
    that no change to its body removes."""
    floor = graph_ms(torch, lambda: fe.launch_noop(torch.device("cuda")))
    print(f"  time  launch floor (no-op kernel, 1 block of 1 thread): "
          f"{floor:.6f} ms [{card}]", flush=True)
    for name in ("fused_stage_energy", "fused_stage_energy_noreproj",
                 "heatmap_sample", "heatmap_sample_bwd"):
        ms, bms = rows[name][0], rows[name][2]
        print(f"  time  {name} at its first timed shape: {ms:.6f} ms = "
              f"{ms / floor:.2f} x the launch floor (bound {bms:.6f} ms) "
              f"[{card}]", flush=True)
    return floor


def decode_bound(r, b, k, crop_bytes):
    """Kernel 5's bound on the CUDA cores: the chain's forward and
    input-transpose operations plus kernel 1's per point, over the
    float32 peak, against h0 in, dE/dh0 and e out, the context and the
    weights read once."""
    return bound_of(*decode_work(r, b, k, crop_bytes))


def decode_work(r, b, k, crop_bytes):
    """(bytes, float32 operations) of one kernel-5 call."""
    rows = r * b
    weights = sum((3 * a + 1) * c for a, c in zip(DEC_DIMS[:-1],
                                                  DEC_DIMS[1:])) * 4
    nbytes = (rows * (T * DEC_DIMS[0] * 4 * 2 + 4) + weights
              + b * (3 * L * 4 + k * k * L * crop_bytes + 3 * L * 4))
    ops = rows * (DEC_OPS_PER_ROW
                  + L * (OPS_PER_CELL * k * k + OPS_PER_POINT_REPROJ))
    return nbytes, ops


def decode_tf32_bound(r, b, k, crop_bytes):
    """Kernel 5's least time at float32-equivalent accuracy on the card:
    the chain as three TF32 passes (3xTF32) over the dense TF32 peak,
    the energy's operations over the float32 peak, the bytes over the HBM
    rate; the largest of the three (the units overlap)."""
    nbytes, ops = decode_work(r, b, k, crop_bytes)
    chain = r * b * DEC_OPS_PER_ROW
    times = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3,
             "operations": max(3 * chain / TF32_FLOP_PER_S,
                               (ops - chain) / F32_FLOP_PER_S) * 1e3}
    by = max(times, key=times.get)
    return times[by], by


def decode_plan_line(fde, r, b):
    """The kernel source's plan for R*B rows, as chip_smoke prints it."""
    import torch
    p = fde.plan(DEC_DIMS, r * b, torch.device("cuda"))
    return (f"plan {p.rows_per_block} rows a CTA, {p.cluster} CTA a "
            f"cluster, {p.ctas} CTAs, {p.stages} ring stages of "
            f"{p.stage_bytes} B of weights, {p.smem} B shared memory a CTA; "
            f"L2 weight reads {p.l2_bytes} B")


def decode_time_line(ms, r, b, k):
    """Kernel 5's time beside both bounds and both shares."""
    b32, by32 = decode_bound(r, b, k, 2)
    btf, bytf = decode_tf32_bound(r, b, k, 2)
    return (f"kernel {ms:.6f} ms; bound at float32 on the CUDA cores "
            f"{b32:.6f} ms ({by32}), share {b32 / ms:.4f}; bound at 3xTF32 "
            f"on the tensor cores {btf:.6f} ms ({bytf}), share "
            f"{btf / ms:.4f}"), btf, bytf


def timing_decode(torch, fe, fde, fisheye, seed, b, card):
    """Kernel 5 at path C's shapes (R=2 probes, R=1, and the guard trip's
    R=4 with k=16 crops; bf16 crops) and at R=4, B=300, each beside the
    plan the kernel source picks (rows a CTA, cluster, CTAs, ring stages,
    the weight bytes its CTAs read from L2), both bounds (float32 on the
    CUDA cores; 3xTF32 on the tensor cores) and both shares, and
    its plain version; and one stage-1 eval both ways at path C's shapes:
    the first dense layer, kernel 5 and dz (fused), against the
    cuDNN/cuBLAS decode forward and backward around kernel 1 (unfused),
    on one random prior (events, host launch cost included).  Returns the
    R=2 row, its bound the 3xTF32 one."""
    import torch.nn.functional as F
    from globalegomocap_tpu_torch.models.conv_vae import ConvVAE, init_random
    from globalegomocap_tpu_torch.ops import cuda_build as cb
    gen = torch.Generator(device="cuda").manual_seed(seed + 19)
    model = init_random(ConvVAE(use_bn=False),
                        torch.Generator().manual_seed(seed + 19))
    model = model.cuda().eval().requires_grad_(False)
    fw, fb, dl = fde.decoder_layers(model)
    row = None
    for r, k in ((2, 8), (1, 8), (4, 16)):
        args = decode_inputs(r, b, k, torch.bfloat16, gen, torch, fe, fde,
                             fisheye)
        fn = lambda: fde.decode_energy_and_grad(*args)  # noqa: E731
        ms = graph_ms(torch, fn)
        with cb.plain_versions_on_cuda():
            plain = event_ms(torch, fn, reps=5)
        text, bms, by = decode_time_line(ms, r, b, k)
        ctx = args[2:7] + ((args[7], args[8]),) + args[9:]
        z = torch.randn((r, b, LATENT), generator=gen, device="cuda")

        def fused_eval():
            with torch.enable_grad():
                zz = z.detach().requires_grad_(True)
                h0 = F.linear(zz, fw, fb).reshape(r, b, T, DEC_DIMS[0])
                e = fde.fused_decode_stage_energy(h0, dl, *ctx)
                return torch.autograd.grad(e.sum(), zz)[0]

        def unfused_eval():
            with torch.enable_grad():
                zz = z.detach().requires_grad_(True)
                pose = model.decode_to_bodypose(zz.reshape(r * b, LATENT))
                pose_rt = pose.reshape(r, b, L, 3).permute(0, 1, 3, 2) \
                    .contiguous()
                e = fe.fused_stage_energy(pose_rt, *ctx)
                return torch.autograd.grad(e.sum(), zz)[0]

        t_f = event_ms(torch, fused_eval)
        t_u = event_ms(torch, unfused_eval)
        print(f"  time  fused_decode_stage_energy R={r} B={b} k={k} bf16 "
              f"crops: {text}; plain version {plain:.6f} ms (no single "
              f"library call computes it); {decode_plan_line(fde, r, b)} "
              f"[{card}]", flush=True)
        print(f"  time  stage-1 eval R={r} B={b} k={k} (value and dE/dz): "
              f"first dense + kernel 5 + dz {t_f:.6f} ms; cuDNN/cuBLAS "
              f"decode fwd+bwd + kernel 1 {t_u:.6f} ms [{card}]",
              flush=True)
        if row is None:
            row = (ms, plain, bms, by, None)
    args = decode_inputs(4, 300, 8, torch.bfloat16, gen, torch, fe, fde,
                         fisheye)
    ms = graph_ms(torch, lambda: fde.decode_energy_and_grad(*args))
    text, _, _ = decode_time_line(ms, 4, 300, 8)
    print(f"  time  fused_decode_stage_energy R=4 B=300 k=8 bf16 crops (1200 "
          f"rows): {text}; {decode_plan_line(fde, 4, 300)} [{card}]",
          flush=True)
    return row


def profile_phase(torch, solve):
    """Where one call of `solve` spends time (torch.profiler): wall time,
    device busy time, idle share and the top kernels; then the host's
    operators by self time (the profiler's own cost included, so read them
    as shares and counts).  A warm call runs first."""
    from torch.profiler import ProfilerActivity, profile
    solve()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        solve()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device-side rows only (kernels, copies): the aten rows repeat them
    events = [e for e in prof.key_averages()
              if str(e.device_type).endswith("CUDA")
              and e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    print(f"  profile: wall {wall_ms:.3f} ms, device busy {busy_ms:.3f} ms, "
          f"idle share {1 - busy_ms / wall_ms:.4f}", flush=True)
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:15]:
        print(f"  profile   {e.self_device_time_total / 1e3:10.3f} ms "
              f"{e.count:6d}x  {e.key[:90]}", flush=True)
    host = [e for e in prof.key_averages()
            if str(e.device_type).endswith("CPU")
            and e.self_cpu_time_total > 0]
    host_ms = sum(e.self_cpu_time_total for e in host) / 1e3
    print(f"  profile: host self time {host_ms:.3f} ms over "
          f"{sum(e.count for e in host)} operator calls", flush=True)
    for e in sorted(host, key=lambda e: -e.self_cpu_time_total)[:10]:
        print(f"  profile   host {e.self_cpu_time_total / 1e3:10.3f} ms "
              f"{e.count:6d}x  {e.key[:80]}", flush=True)


def make_work(torch, seed, tmp, shape=(SEQUENCES, CHUNKS, FRAMES)):
    """The serve traffic (`shape` is (sequences, chunks, frames)) as chunk
    directories and two random full-width priors under `tmp`.  Returns
    (tmp, data root, local prior, global prior)."""
    n_seq, n_chunks, n_frames = shape
    data = os.path.join(tmp, "incoming")
    t0 = time.perf_counter()
    write_sequences(data, n_seq, n_chunks, n_frames, seed)
    local_ckpt, global_ckpt = write_priors(tmp, seed, torch)
    print(f"  wrote {n_seq} sequences x {n_chunks} chunks x {n_frames} "
          f"frames and two random priors in {time.perf_counter() - t0:.1f} "
          f"s", flush=True)
    return tmp, data, local_ckpt, global_ckpt


def staging_in_turns(torch, opt, chunks, fails, card, sync, rounds=3):
    """One warm request's host staging (`SequenceOptimizer.stage`) with
    the native crop (`native/hostcrop.c`, serve's) and with the numpy
    crop swapped in, in turns (native, numpy, numpy, native, ...); both
    must stage the same batch."""
    from globalegomocap_tpu_torch.energy.terms import (
        crop_heatmaps_channels_last_np)
    from globalegomocap_tpu_torch.optimize import driver
    native = driver.crop_peak_native

    def numpy_crop(heat, k):
        cr, org, hw, box, total = crop_heatmaps_channels_last_np(heat, k)
        return cr.reshape(cr.shape[0], -1), org, hw, box, total
    times, staged = {"native": [], "numpy": []}, {}
    order = ["native", "numpy", "numpy", "native"] * ((rounds + 1) // 2)
    for way in order[:2 * rounds]:
        driver.crop_peak_native = native if way == "native" else numpy_crop
        try:
            t0 = time.perf_counter()
            staged[way] = opt.stage(chunks, on_host=True)
            sync()
            times[way].append((time.perf_counter() - t0) * 1e3)
        finally:
            driver.crop_peak_native = native
    print("  host staging of one warm request in turns (ms): native crop "
          + "/".join(f"{t:.3f}" for t in times["native"]) + ", numpy crop "
          + "/".join(f"{t:.3f}" for t in times["numpy"])
          + f" [{card}]", flush=True)
    a, b = staged["native"], staged["numpy"]
    fails.check(all(bool(torch.equal(getattr(a, n), getattr(b, n)))
                    for n in ("est", "cams", "heat", "gt", "origins"))
                and a.crop_coverage == b.crop_coverage,
                f"the native and the numpy crop stage the same batch "
                f"(coverage {a.crop_coverage} and {b.crop_coverage})")


def serve_phase(torch, seed, dev, fails, card, work, profile=False,
                shape=(SEQUENCES, CHUNKS, FRAMES)):
    """The main path: serve over synthetic sequences at full width with
    the launch counts reset just before and read just after, the
    guard-trip path, and the serve run again with the plain versions.
    `work` comes from `make_work` with the same `shape`; only a rehearsal
    on the CPU passes a smaller one.  Returns the main run's launch
    counts."""
    import numpy as np
    from globalegomocap_tpu_torch.cli import serve
    from globalegomocap_tpu_torch.data.test_data import (
        list_chunk_dirs, load_test_chunk)
    from globalegomocap_tpu_torch.ops import fused_energy as fe
    from globalegomocap_tpu_torch.optimize.driver import (
        SequenceOptimizer, build_model)
    from globalegomocap_tpu_torch.optimize.window import num_windows
    n_seq, n_chunks, n_frames = shape
    sync = torch.cuda.synchronize if dev == "cuda" else (lambda: None)
    wins = num_windows(n_frames) * n_chunks
    tmp, data, local_ckpt, global_ckpt = work
    base = ["--data_root", data, "--local_ckpt", local_ckpt,
            "--global_ckpt", global_ckpt, "--device", dev,
            "--compute_dtype", "float32", "--save_pose", "true"]
    cfg = serve.config_from_args(serve.build_parser().parse_args(base))
    per_seq = {"fused_stage_energy": 1 + cfg.solver.max_iter,
               "fused_stage_energy_noreproj":
                   1 + cfg.solver.global_max_iter}

    fe.reset_launches()                      # the main path's run
    recs, wall = run_serve(serve, base + ["--out_dir",
                                          os.path.join(tmp, "kernel")])
    launches = dict(fe.LAUNCHES)
    print(f"  launches {launches} in {wall:.2f} s", flush=True)
    fails.check(len(recs) == n_seq
                and all("error" not in r for r in recs),
                f"serve answered {len(recs)} of {n_seq} sequences")
    for name, n in per_seq.items():
        fails.check(launches[name] == n * n_seq,
                    f"{name}: {launches[name]} launches, "
                    f"{n * n_seq} expected")
    fails.check(all(r.get("windows") == wins for r in recs),
                f"{wins} windows per request")
    fails.check(all(all(abs(float(r[key])) < float("inf")
                        for key in ("optimized_global_mpjpe",
                                    "original_global_mpjpe"))
                    for r in recs), "serve metrics finite")

    # the crop-guard trip path: k=16 estimate-centred crops, robust tier
    opt = SequenceOptimizer(build_model(cfg),
                            serve.load_state(local_ckpt),
                            serve.load_state(global_ckpt), cfg,
                            device=dev)
    chunks = [load_test_chunk(d) for d in
              list_chunk_dirs(os.path.join(data, "seq0"))]
    # one warm request split into host staging and the solve
    t0 = time.perf_counter()
    staged_peak = opt.stage(chunks, on_host=True)
    t_stage = time.perf_counter() - t0
    opt.optimize_chunks_batched(staged_peak, mode="flat")
    sync()
    t0 = time.perf_counter()
    opt.optimize_chunks_batched(staged_peak, mode="flat")
    sync()
    t_solve = time.perf_counter() - t0
    print(f"  one warm request of {wins} windows: host staging "
          f"{t_stage * 1e3:.3f} ms, solve {t_solve * 1e3:.3f} ms "
          f"[{card}]", flush=True)
    staging_in_turns(torch, opt, chunks, fails, card, sync)

    staged = opt.stage(chunks, on_host=True, coverage=0.1)
    fe.reset_launches()
    res = opt.optimize_chunks_batched(staged, mode="flat")
    sync()
    g_launch = dict(fe.LAUNCHES)
    robust = opt._cfg_for_coverage(0.1).solver
    fails.check(staged.heat.shape[-1] == 16 * 16 * J
                and staged.heat.dtype == torch.bfloat16,
                f"guard trip staged k=16 bf16 crops "
                f"{tuple(staged.heat.shape)}")
    fails.check(g_launch == {
        "fused_stage_energy": 1 + robust.max_iter,
        "fused_stage_energy_noreproj": 1 + robust.global_max_iter,
        "heatmap_sample": 0, "heatmap_sample_bwd": 0,
        "lbfgs_direction": 0, "fused_decode_stage_energy": 0},
        f"guard trip launches {g_launch} (robust tier: "
        f"{robust.max_iter} iterations, {len(robust.step_candidates)} "
        f"step candidates)")
    fails.check(all(bool(torch.isfinite(x).all()) for x in res),
                "guard trip outputs finite")

    # every kernel call of a full serve run checked against the plain
    # version on the same arguments, along the kernels' own trajectory
    log = []
    with shadowed(torch, fe, log):
        run_serve(serve, base + ["--out_dir", os.path.join(tmp, "sh")])
    for name in per_seq:
        rows = [a for n, _, a in log if n == name]
        fails.check(
            len(rows) == per_seq[name] * n_seq
            and all(a[0] for a in rows),
            f"{name} on the serve path: {len(rows)} calls, each "
            f"against the plain version on its own arguments: "
            f"max|de|={max(a[1] for a in rows):.3e} "
            f"max|dg|={max(a[2] for a in rows):.3e} "
            f"max|dg|/(1+|g|)={max(a[3] for a in rows):.3e}, "
            f"{sum(a[4] for a in rows)} points at a kink left out")

    # the same serve run with the plain versions swapped in.  With a
    # random prior the first steps (scaled by 1/|g|_1) barely move the
    # energy, so the line search's Armijo test decides some windows on
    # float32 rounding, and the two runs branch there (the CPU tests
    # see the same between the JAX package and the port).  The shadow
    # run above holds every kernel call tightly; here the full run is
    # held by its metrics (1 %) and by the share of frames within
    # 1 cm, and a 2+1-iteration run, where few windows have branched,
    # by the share within 1e-5 m and its worst frame.
    with fe.plain_versions_on_cuda():
        precs, pwall = run_serve(serve, base + [
            "--out_dir", os.path.join(tmp, "plain")])
    print(f"  plain-version serve run in {pwall:.2f} s", flush=True)
    for r, p in zip(recs, precs):
        a, b = r["optimized_global_mpjpe"], p["optimized_global_mpjpe"]
        fails.check(abs(a - b) <= 0.01 * abs(b),
                    f"{r['sequence']} optimized_global_mpjpe {a} with "
                    f"the kernels, {b} with the plain versions (1 %)")
        print(f"  serve {r['sequence']}: latency {r['latency_ms']} ms, "
              f"{r['windows_per_sec']} windows/s (plain versions: "
              f"{p['latency_ms']} ms, {p['windows_per_sec']} windows/s) "
              f"[{card}]", flush=True)
    covered = (num_windows(n_frames) - 1) * 8 + 10
    short = ["--max_iter", "2", "--global_max_iter", "1"]
    run_serve(serve, base + short + ["--out_dir",
                                     os.path.join(tmp, "kernel2")])
    with fe.plain_versions_on_cuda():
        run_serve(serve, base + short + ["--out_dir",
                                         os.path.join(tmp, "plain2")])
    for s in range(n_seq):
        for tag, run, ref in (("12+3", "kernel", "plain"),
                              ("2+1", "kernel2", "plain2")):
            a = np.load(os.path.join(tmp, run, f"seq{s}",
                                     "optimized.npy"))
            b = np.load(os.path.join(tmp, ref, f"seq{s}",
                                     "optimized.npy"))
            fails.check(a.shape == (n_chunks, covered, J, 3)
                        and bool(np.isfinite(a).all()),
                        f"seq{s} {tag} optimized {a.shape} finite")
            d = np.abs(a - b).max(axis=(-2, -1))   # worst joint/frame
            within = [float((d <= t).mean())
                      for t in (1e-5, 1e-4, 1e-3, 1e-2)]
            line = (f"seq{s} {tag} iterations, optimized poses with the "
                    f"kernels vs the plain versions: share of frames "
                    f"within 1e-5/1e-4/1e-3/1e-2 m "
                    + "/".join(f"{v:.4f}" for v in within)
                    + f", max {float(d.max()):.3e} m")
            if tag == "2+1":
                fails.check(within[0] >= 0.85 and float(d.max()) <= 0.02,
                            line + " (bound: 0.85 within 1e-5 m, all "
                            "within 0.02 m)")
            else:
                fails.check(within[3] >= 0.95,
                            line + " (bound: 0.95 within 1e-2 m)")

    if profile:
        print("[3b] profile of one serve solve", flush=True)
        profile_phase(torch, lambda: opt.optimize_chunks_batched(
            staged_peak, mode="flat"))
    return launches


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true",
                    help="also profile one serve solve, one path A chunk, "
                         "one path D chunk, one path B solve and one path "
                         "C solve with and without kernel 5 and at float32 "
                         "(torch.profiler)")
    args = ap.parse_args(argv)

    if not os.path.isdir(os.path.join(HERE, "globalegomocap_tpu_torch")):
        print("chip_smoke: no globalegomocap_tpu_torch package beside this "
              "script; run it from a checkout of the repository",
              file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this check "
              "needs one CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from globalegomocap_tpu_torch.ops import cuda_build as cb
    from globalegomocap_tpu_torch.ops import fisheye
    from globalegomocap_tpu_torch.ops import fused_decode_energy as fde
    from globalegomocap_tpu_torch.ops import fused_energy as fe
    from globalegomocap_tpu_torch.ops import heatmap_sample as hs
    from globalegomocap_tpu_torch.ops import lbfgs_direction as ld
    from globalegomocap_tpu_torch.optimize.window import num_windows

    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"card: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, python {sys.version.split()[0]}",
          flush=True)
    fails = Failures()
    t_start = time.perf_counter()
    seconds = {}

    def phase_done(name, t0):
        seconds[name] = time.perf_counter() - t0
        print(f"  ({name}: {seconds[name]:.1f} s)", flush=True)

    # ---- 1. build ---------------------------------------------------------
    print("[1] build", flush=True)
    t0 = time.perf_counter()
    sources = ("fused_energy", "heatmap_sample", "lbfgs_direction",
               "fused_decode_energy")
    built = cb.build_all(sources)
    fe._library(), hs._library(), ld._library(), fde._library()
    for name in sources:
        print(f"  built {os.path.relpath(built[name], HERE)}", flush=True)
        for line in cb.BUILD_LOG.get(name, "").splitlines():
            if "ptxas" in line or "spill" in line:
                print("    " + line.strip(), flush=True)
    phase_done("build", t0)

    # ---- 2. kernels against their plain versions ----------------------------
    wins = num_windows(FRAMES) * CHUNKS               # one serve batch
    print("[2] kernels against their plain versions", flush=True)
    t0 = time.perf_counter()
    max_err = kernel_phase(torch, fe, fisheye, fails, args.seed, wins)
    max_err.update(new_kernel_phase(torch, hs, ld, cb, fails, args.seed))
    max_err["fused_decode_stage_energy"] = decode_kernel_phase(
        torch, fe, fde, fisheye, fails, args.seed, wins)
    phase_done("kernels", t0)

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        # ---- 3. serve -------------------------------------------------------
        print("[3] serve path at full width", flush=True)
        t0 = time.perf_counter()
        work = make_work(torch, args.seed, tmp)
        launches = serve_phase(torch, args.seed, "cuda", fails, card, work,
                               profile=args.profile)
        phase_done("serve", t0)
        # ---- 3d. path A -----------------------------------------------------
        print("[3d] path A: per-chunk full-map path (optimize_sequence)",
              flush=True)
        t0 = time.perf_counter()
        launches.update({k: v for k, v in path_a_phase(
            torch, args.seed, "cuda", fails, card, work,
            profile=args.profile).items()
            if k in ("heatmap_sample", "heatmap_sample_bwd",
                     "lbfgs_direction")})
        phase_done("path A", t0)
        # ---- 3g. path D -----------------------------------------------------
        print("[3g] path D: the parity CLI at its own defaults "
              "(strong-Wolfe L-BFGS, .pth.tar priors)", flush=True)
        t0 = time.perf_counter()
        path_d_phase(torch, args.seed, "cuda", fails, card, work,
                     profile=args.profile)
        phase_done("path D", t0)
        # ---- 3e. path B -----------------------------------------------------
        print("[3e] path B: serve's full-map guard fallback", flush=True)
        t0 = time.perf_counter()
        path_b_phase(torch, "cuda", fails, card, work, profile=args.profile)
        phase_done("path B", t0)
        # ---- 3f. path C -----------------------------------------------------
        print("[3f] path C: serve's flat solve at bfloat16_delta with "
              "kernel 5", flush=True)
        t0 = time.perf_counter()
        launches["fused_decode_stage_energy"] = path_c_phase(
            torch, "cuda", fails, card, work, profile=args.profile)[
            "fused_decode_stage_energy"]
        phase_done("path C", t0)

    # ---- 4. timing ----------------------------------------------------------
    print("[4] timing at the paths' shapes", flush=True)
    t0 = time.perf_counter()
    rows = timing_phase(torch, fe, fisheye, args.seed, wins, card)
    rows = {name: row[:4] + (None,) for name, row in rows.items()}
    rows.update(timing_new(torch, hs, ld, cb, args.seed, card))
    launch_floor(torch, fe, card, rows)
    rows["fused_decode_stage_energy"] = timing_decode(
        torch, fe, fde, fisheye, args.seed, wins, card)
    phase_done("timing", t0)
    kernels = []
    for name in SOURCES:
        ms, plain, bms, by, lib = rows[name]
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": max_err[name], "ms": ms, "plain_ms": plain,
            "bound_ms": bms, "bound_by": by, "library_ms": lib})
    print(f"total {time.perf_counter() - t_start:.1f} s; by phase "
          + ", ".join(f"{k} {v:.1f} s" for k, v in seconds.items()),
          flush=True)
    if fails.items:
        print(f"chip_smoke: {len(fails.items)} check(s) failed:",
              file=sys.stderr)
        for item in fails.items:
            print("  " + item, file=sys.stderr)
        return 1
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
