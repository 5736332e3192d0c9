"""The two-stage latent optimization over a flat batch of windows.

Counterpart of the slice's subset of `globalegomocap_tpu/optimize/
pipeline.py`: stage 1 optimises the local pose in the local prior's
latent space with the heatmap reprojection term (the fused stage-1
kernel); the result is lifted through the SLAM cameras; stage 2 runs the
residual global stage (p(z) = mid + decode(z) - decode(z0)) over the
no-reproj kernel; overlapping windows merge with one matrix that also
applies the final Gaussian smoothing.

Each objective eval decodes all (probe, window) latents in one batch,
runs one kernel for the energy and its pose-gradient, and takes
dE/dz with `torch.autograd.grad` of the summed energies through the
decoder (the JAX `jax.vjp(batch_energy)` with a ones cotangent).
"""

from __future__ import annotations

from dataclasses import replace
from typing import NamedTuple

import torch

from globalegomocap_tpu_torch.config import OptimizeConfig
from globalegomocap_tpu_torch.energy.terms import EnergyWeights
from globalegomocap_tpu_torch.models.conv_vae import ConvVAE
from globalegomocap_tpu_torch.ops import fisheye
from globalegomocap_tpu_torch.ops.fused_energy import (
    fused_stage_energy, fused_stage_energy_noreproj)
from globalegomocap_tpu_torch.ops.skeleton import mean_bone_lengths
from globalegomocap_tpu_torch.ops.transforms import (
    relative_global_pose, relative_to_global_pose, transform_pose)
from globalegomocap_tpu_torch.optimize.lbfgs import (
    lbfgs_minimize_fixed_batched)
from globalegomocap_tpu_torch.optimize.window import (
    merge_windows_matmul, slice_windows)

J = 15


class ChunkResult(NamedTuple):
    """Merged per-chunk sequences (covered frames only), world frame
    except mid_local.  Flat-path fields carry a leading chunk axis."""
    estimated: torch.Tensor   # (C, N, 15, 3) raw input lifted to world
    mid: torch.Tensor         # after stage 1, world frame
    mid_local: torch.Tensor   # after stage 1, camera frame
    optimized: torch.Tensor   # after stage 2, world frame
    gt: torch.Tensor


def check_supported(cfg: OptimizeConfig) -> None:
    """Raise, naming the option, for configurations this slice of the
    port does not run (they wait for later slices)."""
    s, e = cfg.solver, cfg.energy
    impl = cfg.decoder_impl or ("dense" if cfg.dense_decoder else "conv")
    unsupported = [
        (s.method != "lbfgs_fixed", f"solver.method={s.method!r}"),
        (not s.fused_energy, "solver.fused_energy=False"),
        (s.fused_decode, "solver.fused_decode=True"),
        (s.remat, "solver.remat=True"),
        (s.init != "mu", f"solver.init={s.init!r}"),
        (cfg.compute_dtype != "float32",
         f"compute_dtype={cfg.compute_dtype!r} (bf16 solve tiers)"),
        (impl != "conv", f"decoder_impl={impl!r} (dense/shift decoders)"),
        (cfg.decoder_dtype != "float32",
         f"decoder_dtype={cfg.decoder_dtype!r}"),
        (e.reproj != 0.0 and cfg.heatmap_crop <= 0,
         "heatmap_crop=0 (full-map sampling)"),
        (e.soft_smooth != 0.0, "energy.soft_smooth"),
        (e.overlap_consistency != 0.0, "energy.overlap_consistency"),
        (e.gmm != 0.0, "energy.gmm"),
        (e.local_residual, "energy.local_residual=True"),
        (cfg.heatmap_dtype not in ("float32", "bfloat16"),
         f"heatmap_dtype={cfg.heatmap_dtype!r}"),
        (not cfg.matmul_merge, "matmul_merge=False"),
        (not cfg.merge, "merge=False"),
        (cfg.final_smooth and cfg.final_smooth_method != "gaussian",
         f"final_smooth_method={cfg.final_smooth_method!r}"),
    ]
    bad = [name for cond, name in unsupported if cond]
    if bad:
        raise NotImplementedError(
            "not yet ported to the PyTorch package: " + ", ".join(bad))


def stage_weights(cfg: OptimizeConfig):
    """The two stages' energy weights from the CLI-level weights
    (local: w3d/1e4, smooth/100; global: bone 0.01, reproj 0)."""
    e = cfg.energy
    g3d = e.weight_3d if e.global_weight_3d is None else e.global_weight_3d
    gsm = e.smooth if e.global_smooth is None else e.global_smooth
    global_w = EnergyWeights.create(
        weight_3d=g3d, smooth=gsm, bone_length=0.01,
        vae=e.vae, reproj=0.0, gmm=e.gmm, soft_smooth=e.soft_smooth)
    local_w = EnergyWeights.create(
        weight_3d=e.weight_3d / 1e4, smooth=e.smooth / 100.0,
        bone_length=e.bone_length, vae=e.vae, reproj=e.reproj, gmm=e.gmm,
        soft_smooth=e.soft_smooth)
    return local_w, global_w


def _stage2_cfg(cfg: OptimizeConfig) -> OptimizeConfig:
    """Apply the stage-2 iteration override (solver.global_max_iter)."""
    if cfg.solver.global_max_iter is None:
        return cfg
    return replace(cfg, solver=replace(cfg.solver,
                                       max_iter=cfg.solver.global_max_iter))


def _wvec(weights: EnergyWeights, center, device) -> torch.Tensor:
    """[w3d, smooth, bone, vae, reproj, cx, cy, 0] as a (1, 8) tensor."""
    vals = [weights.weight_3d, weights.smooth, weights.bone_length,
            weights.vae, weights.reproj]
    row = torch.tensor(vals + [0.0, 0.0, 0.0], dtype=torch.float32)
    if center is not None:
        row[5:7] = center.to(torch.float32).cpu()
    return row[None].to(device)


def optimize_stage(model: ConvVAE, init_pose, heatmaps, mean_bl,
                   camera: fisheye.FisheyeParams, weights: EnergyWeights,
                   use_reproj: bool, cfg: OptimizeConfig, origins=None,
                   full_hw=None, residual: bool = False) -> torch.Tensor:
    """One optimisation stage over a batch of windows.

    init_pose: (W, T, 15, 3) anchor/init poses.  heatmaps: (W, T, 15, k, k)
    staged peak crops with origins (W, T, 15, 2) as (oy, ox) and the full
    map extent full_hw (stage 1), or None (stage 2).  mean_bl: (W, 15).
    Returns the decoded optimised poses (W, T, 15, 3)."""
    w, t = init_pose.shape[0], init_pose.shape[1]
    L = t * J
    s = cfg.solver
    with torch.no_grad():
        mu, _ = model.encode(init_pose.reshape(w, t, 3 * J))
        offset = (init_pose - model.decode_to_bodypose(mu)) if residual \
            else None
    latent = mu.shape[-1]
    dev = init_pose.device
    anchor_t = init_pose.reshape(w, L, 3).permute(0, 2, 1).contiguous()
    bone_t = mean_bl.repeat(1, t).contiguous()                # (W, L)

    if use_reproj:
        kk = heatmaps.shape[-1]
        crops_cm = heatmaps.reshape(w, L, kk * kk).transpose(1, 2)
        if cfg.heatmap_dtype == "bfloat16":
            crops_cm = crops_cm.to(torch.bfloat16)
        crops_cm = crops_cm.contiguous()
        f_ox = origins[..., 1].reshape(w, L).contiguous()
        f_oy = origins[..., 0].reshape(w, L).contiguous()
        ctx = (_wvec(weights, camera.center, dev),
               camera.poly_w2c[None].to(dev, torch.float32).contiguous())
        hg = cfg.heatmap

        def energy(pose_rt):
            return fused_stage_energy(pose_rt, anchor_t, crops_cm, f_ox,
                                      f_oy, bone_t, ctx, t, J, kk, full_hw,
                                      hg.crop_offset, hg.half_extent)
    else:
        wvec = _wvec(weights, None, dev)

        def energy(pose_rt):
            return fused_stage_energy_noreproj(pose_rt, anchor_t, bone_t,
                                               wvec, t, J)

    def vg_batch(z3):
        rr, bb = z3.shape[0], z3.shape[1]
        with torch.enable_grad():
            z = z3.detach().requires_grad_(True)
            pose = model.decode_to_bodypose(z.reshape(rr * bb, latent))
            if offset is not None:
                pose = (pose.reshape((rr, bb) + pose.shape[1:])
                        + offset[None]).reshape(pose.shape)
            pose_rt = pose.reshape(rr * bb, L, 3).permute(0, 2, 1) \
                .reshape(rr, bb, 3, L).contiguous()
            vals = energy(pose_rt)
            (gz,) = torch.autograd.grad(vals.sum(), z)
        return vals.detach(), gz

    with torch.no_grad():
        res = lbfgs_minimize_fixed_batched(
            vg_batch, mu, max_iter=s.max_iter, history_size=s.history_size,
            lr=s.lr, step_candidates=tuple(s.step_candidates),
            unroll=s.unroll)
        out = model.decode_to_bodypose(res.x)
        return out if offset is None else out + offset


def _unflatten_staged_crops(heatmap_seq, origins, cfg: OptimizeConfig):
    """Undo the flat staged-crop layout (..., k*k*J) -> (..., k, k, J).
    No-op for already 5-D crops (crops are origins.ndim + 1 dims, flat
    crops origins.ndim - 1)."""
    if origins is None or heatmap_seq.dim() != origins.dim() - 1:
        return heatmap_seq
    k = cfg.heatmap_crop
    j = heatmap_seq.shape[-1] // (k * k)
    return heatmap_seq.reshape(heatmap_seq.shape[:-1] + (k, k, j))


def optimize_chunks_flat(local_model: ConvVAE, global_model: ConvVAE,
                         estimated_local, camera_seq, heatmap_seq, gt_seq,
                         camera: fisheye.FisheyeParams, cfg: OptimizeConfig,
                         origins=None, full_hw=None) -> ChunkResult:
    """Optimise many equal-length chunks with the windows of all chunks
    concatenated into one flat solver batch.  All inputs carry a leading
    chunk axis (C, N, ...); heatmap_seq is the staged crops (flat
    (C, N, k*k*J) or (C, N, k, k, J)) with origins (C, N, J, 2) and
    full_hw.  Returns (C, covered, 15, 3) fields."""
    check_supported(cfg)
    if (origins is None) != (full_hw is None):
        raise ValueError("origins and full_hw must be supplied together")
    use_reproj = cfg.energy.reproj != 0.0
    if use_reproj and origins is None:
        raise NotImplementedError(
            "stage 1 takes staged crops (stage(on_host=True)); "
            "in-solve cropping of full maps is not ported")
    c = estimated_local.shape[0]
    seq_len, stride = cfg.window.seq_len, cfg.window.stride
    local_w, global_w = stage_weights(cfg)

    def windows_of(x):
        return slice_windows(x, seq_len, stride, dim=1)

    win_local = windows_of(estimated_local)           # (C, W, T, 15, 3)
    win_cam = windows_of(camera_seq)
    win_gt = windows_of(gt_seq)
    w_per = win_local.shape[1]

    def flat(x):
        return x.reshape((c * w_per,) + x.shape[2:])

    f_heat = f_org = None
    if use_reproj:
        heat = _unflatten_staged_crops(heatmap_seq, origins, cfg)
        f_heat = flat(windows_of(heat).movedim(-1, 3))    # (CW,T,J,k,k)
        f_org = flat(windows_of(origins))                  # (CW,T,J,2)

    bl = mean_bone_lengths(estimated_local)               # (C, 15)
    bl_flat = bl.repeat_interleave(w_per, dim=0)          # (C*W, 15)
    f_local, f_cam = flat(win_local), flat(win_cam)

    mid_local = optimize_stage(local_model, f_local, f_heat, bl_flat,
                               camera, local_w, use_reproj, cfg,
                               origins=f_org, full_hw=full_hw)

    # world lifts go straight through the per-frame cameras
    # (cam0 . (inv(cam0) . C_i) == C_i); only stage 2's anchor needs the
    # relative hop
    mid_rel = relative_global_pose(mid_local, f_cam)
    cam0 = f_cam[:, 0]
    est_world = transform_pose(f_local, f_cam)
    mid_world = transform_pose(mid_local, f_cam)

    opt_rel = optimize_stage(global_model, mid_rel, None, bl_flat, camera,
                             global_w, False, _stage2_cfg(cfg),
                             residual=cfg.energy.global_residual)
    opt_world = relative_to_global_pose(opt_rel, cam0)

    sigma = cfg.final_smooth_sigma if cfg.final_smooth else 0.0

    def unflat_merge(x, smooth=0.0):
        per_chunk = x.reshape((c, w_per) + x.shape[1:])
        return merge_windows_matmul(per_chunk, stride, smooth,
                                    batch_dims=1)

    return ChunkResult(
        estimated=unflat_merge(est_world),
        mid=unflat_merge(mid_world),
        mid_local=unflat_merge(mid_local),
        optimized=unflat_merge(opt_world, sigma),
        gt=unflat_merge(flat(win_gt)),
    )
