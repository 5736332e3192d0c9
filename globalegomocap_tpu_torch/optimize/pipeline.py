"""The two-stage latent optimization over a batch of windows.

Counterpart of `globalegomocap_tpu/optimize/pipeline.py`: stage 1
optimises the local pose in the local prior's latent space with the
heatmap reprojection term (optionally the residual form, as stage 2);
the result is lifted through the SLAM cameras; stage 2 optimises the
global pose (reprojection off, optionally the residual p(z) = mid +
decode(z) - decode(z0)); overlapping windows merge with one matrix that
also applies the final Gaussian smoothing (or by a scatter mean, and
with a one-euro smoothing, as the configuration asks).

Three entry points, as in the JAX package:

- `optimize_chunk`: one chunk, per-window solves (`solver.method`'s
  solver with the window axis written out: strong-Wolfe `lbfgs_minimize`,
  `lbfgs_minimize_fixed` or `adam_minimize`), k x k crops cut on the
  device before windowing when `heatmap_crop` > 0, else full maps;
- `optimize_chunks_flat`: many equal-length chunks with all windows in
  one flat batch (`lbfgs_minimize_fixed_batched`), on staged crops or on
  full maps (the guard-trip fallback with `guard_crop` = 0);
- `optimize_chunks_batched`: many equal-length chunks, `optimize_chunk`
  on each (the JAX package's mode="vmap");

and `make_chunk_optimizer`, `optimize_chunk` as a closure over a config
and a camera that takes the priors' state dicts (eager: the JAX
package's jit has no counterpart).

`optimize_stage` picks the energy as the JAX one does: the fused stage-1
kernel on staged crops (or, with `solver.fused_decode`, kernel 5, which
runs the decoder's conv chain too), the fused no-reproj kernel for stage
2, else the plain PyTorch energy (`energy/terms.py`), whose full-map
sampling runs the `heatmap_sample` kernel with `sampling_impl="pallas"`.
The soft-smooth term (an anchor to the input smoothed over time) and the
cross-window coupling (one joint solve over a chunk's window latents)
turn the batched solver off, as in JAX; `solver.remat` recomputes the
decoder in the backward pass of those solves.
Each objective eval decodes all (probe, window) latents in one batch and
takes dE/dz with autograd through the decoder: the conv layers, or with
`decoder_impl` "dense" / "shift" the matmul decoders of
`models/dense_decoder.py` (as JAX's `_make_decode_batch` wires them, at
`decoder_dtype` storage).  `cfg.compute_dtype`
selects the JAX package's bf16 solve tiers: the priors come in as
`StageModels`, cast for the tier once (`stage_models`), or as plain
ConvVAEs, converted per stage."""

from __future__ import annotations

import copy
import functools
from dataclasses import replace
from typing import Callable, NamedTuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from globalegomocap_tpu_torch.config import OptimizeConfig
from globalegomocap_tpu_torch.energy.terms import (
    EnergyWeights, crop_heatmaps_at_centers_channels_last,
    crop_heatmaps_channels_last, overlap_consistency_energy,
    projected_estimate_centers, total_energy_from_pose)
from globalegomocap_tpu_torch.models.conv_vae import ConvVAE, sample_init
from globalegomocap_tpu_torch.models.dense_decoder import (
    make_dense_decoder, make_shift_decoder)
from globalegomocap_tpu_torch.ops import fisheye
from globalegomocap_tpu_torch.ops.fused_decode_energy import (
    decoder_layers, fused_decode_stage_energy)
from globalegomocap_tpu_torch.ops.filtering import (
    gaussian_filter1d, one_euro_filter)
from globalegomocap_tpu_torch.ops.fused_energy import (
    fused_stage_energy, fused_stage_energy_noreproj)
from globalegomocap_tpu_torch.ops.skeleton import mean_bone_lengths
from globalegomocap_tpu_torch.ops.transforms import (
    relative_global_pose, relative_to_global_pose, transform_pose)
from globalegomocap_tpu_torch.optimize.lbfgs import (
    adam_minimize, lbfgs_minimize, lbfgs_minimize_fixed,
    lbfgs_minimize_fixed_batched)
from globalegomocap_tpu_torch.optimize.window import (
    merge_windows, merge_windows_matmul, slice_windows)

J = 15
COMPUTE_DTYPES = ("float32", "bfloat16", "bfloat16_f32enc",
                  "bfloat16_f32head", "bfloat16_delta", "bfloat16_pure")
DECODER_IMPLS = ("conv", "dense", "shift")


class ChunkResult(NamedTuple):
    """Merged per-chunk sequences (covered frames only), world frame
    except mid_local.  Flat-path fields carry a leading chunk axis."""
    estimated: torch.Tensor   # (N, 15, 3) raw input lifted to world
    mid: torch.Tensor         # after stage 1, world frame
    mid_local: torch.Tensor   # after stage 1, camera frame
    optimized: torch.Tensor   # after stage 2, world frame
    gt: torch.Tensor


def check_supported(cfg: OptimizeConfig) -> None:
    """Raise ValueError for an option value neither package knows."""
    if cfg.solver.init not in ("mu", "sample"):
        raise ValueError(f"solver.init={cfg.solver.init!r}")
    impl = cfg.decoder_impl or ("dense" if cfg.dense_decoder else "conv")
    unknown = [
        (cfg.compute_dtype not in COMPUTE_DTYPES,
         f"compute_dtype={cfg.compute_dtype!r}"),
        (impl not in DECODER_IMPLS, f"decoder_impl={impl!r}"),
        (cfg.decoder_dtype not in ("float32", "bfloat16"),
         f"decoder_dtype={cfg.decoder_dtype!r}"),
        (cfg.sampling_impl not in ("gather", "dense", "pallas"),
         f"sampling_impl={cfg.sampling_impl!r}"),
        (cfg.heatmap_dtype not in ("float32", "bfloat16"),
         f"heatmap_dtype={cfg.heatmap_dtype!r}"),
        (cfg.final_smooth_method not in ("gaussian", "one_euro"),
         f"final_smooth_method={cfg.final_smooth_method!r}"),
    ]
    bad = [name for cond, name in unknown if cond]
    if bad:
        raise ValueError("unknown option values: " + ", ".join(bad))


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


def _solve(cfg: OptimizeConfig, loss, z0):
    """The per-window solve of solver.method over the lanes of z0 (W, d):
    'adam', 'lbfgs_fixed', else the strong-Wolfe 'lbfgs' (as JAX's
    `_solve` dispatches)."""
    s = cfg.solver
    if s.method == "adam":
        return adam_minimize(loss, z0, steps=s.adam_steps, lr=s.adam_lr)
    if s.method == "lbfgs_fixed":
        return lbfgs_minimize_fixed(
            loss, z0, max_iter=s.max_iter, history_size=s.history_size,
            lr=s.lr, step_candidates=tuple(s.step_candidates),
            fused_probes=s.fused_probes,
            compact_direction=s.compact_direction,
            circular_history=s.circular_history,
            pallas_direction=s.pallas_direction, unroll=s.unroll)
    return lbfgs_minimize(
        loss, z0, max_iter=s.max_iter, history_size=s.history_size,
        lr=s.lr, tolerance_change=s.tolerance_change,
        tolerance_grad=s.tolerance_grad, max_ls_evals=s.max_ls_evals)


def _stage2_cfg(cfg: OptimizeConfig) -> OptimizeConfig:
    """Apply the stage-2 iteration override (solver.global_max_iter)."""
    if cfg.solver.global_max_iter is None:
        return cfg
    return replace(cfg, solver=replace(cfg.solver,
                                       max_iter=cfg.solver.global_max_iter))


@functools.lru_cache(maxsize=64)
def _weight_row(vals: tuple, device: torch.device) -> torch.Tensor:
    """(1, 8) float32 [*vals, 0, 0, 0] on `device`, copied there at the
    first call only (a solve on the card then issues no host-to-device
    copy, which would wait for the work already queued).  Read-only."""
    return torch.tensor([list(vals) + [0.0, 0.0, 0.0]], dtype=torch.float32,
                        device=device)


def _wvec(weights: EnergyWeights, center, device) -> torch.Tensor:
    """[w3d, smooth, bone, vae, reproj, cx, cy, 0] as a (1, 8) tensor on
    `device`; the camera centre `center` (2,) joins on the device."""
    row = _weight_row((weights.weight_3d, weights.smooth,
                       weights.bone_length, weights.vae, weights.reproj),
                      device)
    if center is None:
        return row
    return torch.cat([row[:, :5], center.to(device, torch.float32)[None],
                      row[:, 7:]], dim=1)


def _fused_energy(init_pose, heatmaps, mean_bl, camera, weights,
                  use_reproj, cfg, origins, full_hw, decoder=None):
    """The fused kernels' energy with its loop-invariant context built
    once: of (R, W, 3, L) poses, or, with `decoder` = (first_w, first_b,
    DecoderLayers) from `decoder_layers`, of (R, W, latent) float32
    latents through the first dense layer and kernel 5."""
    w, t = init_pose.shape[0], init_pose.shape[1]
    L = t * J
    dev = init_pose.device
    anchor_t = init_pose.reshape(w, L, 3).permute(0, 2, 1).contiguous()
    bone_t = mean_bl.repeat(1, t).contiguous()                # (W, L)
    if not use_reproj:
        wvec = _wvec(weights, None, dev)
        return lambda pose_rt: fused_stage_energy_noreproj(
            pose_rt, anchor_t, bone_t, wvec, t, J)
    kk = heatmaps.shape[-1]
    crops_cm = heatmaps.reshape(w, L, kk * kk).transpose(1, 2).contiguous()
    f_ox = origins[..., 1].reshape(w, L).contiguous()
    f_oy = origins[..., 0].reshape(w, L).contiguous()
    ctx = (_wvec(weights, camera.center, dev),
           camera.poly_w2c[None].to(dev, torch.float32).contiguous())
    hg = cfg.heatmap
    if decoder is None:
        return lambda pose_rt: fused_stage_energy(
            pose_rt, anchor_t, crops_cm, f_ox, f_oy, bone_t, ctx, t, J, kk,
            full_hw, hg.crop_offset, hg.half_extent)
    first_w, first_b, layers = decoder

    def energy(z3):
        rr, bb = z3.shape[0], z3.shape[1]
        h0 = F.linear(z3, first_w, first_b).reshape(rr, bb, t, -1)
        return fused_decode_stage_energy(
            h0, layers, anchor_t, crops_cm, f_ox, f_oy, bone_t, ctx, t, J,
            kk, full_hw, hg.crop_offset, hg.half_extent)
    return energy


class StageModels(NamedTuple):
    """One prior as the stages of a compute tier use it (`stage_models`):
    the encode, eval and output models, each holding its weights in its
    compute dtypes; for solver.fused_decode, kernel 5's float32 decoder
    (`decoder_layers`); and the eval and output decodes z (B, latent) ->
    (B, T, 15, 3) of the decoder implementation `impl` = (decoder_impl,
    decoder_dtype)."""
    tier: str
    enc: ConvVAE
    evals: ConvVAE
    out: ConvVAE
    decoder: tuple | None
    decode_eval: Callable
    decode_out: Callable
    impl: tuple


def decoder_impl(cfg: OptimizeConfig) -> tuple:
    """(decoder_impl, decoder_dtype) as the JAX pipeline resolves them:
    an empty decoder_impl follows dense_decoder."""
    return (cfg.decoder_impl or ("dense" if cfg.dense_decoder else "conv"),
            cfg.decoder_dtype)


def stage_models(model: ConvVAE, tier: str, fused_decode: bool = False,
                 impl: tuple = ("conv", "float32")) -> StageModels:
    """`model`'s weights cast and converted for the stages of `tier`.
    `model` carries float32 weights and the tier's dtype
    (`driver.build_model`); the weights are constants from here on, and
    `SequenceOptimizer` builds these once per prior.

    float32: all float32.  bfloat16 (the mixed tier) and bfloat16_delta:
    float32 encode and output decode, bf16 evals.  bfloat16_f32enc: float32
    encode, bf16 evals and output.  bfloat16_f32head: bf16 encoder with a
    float32 fc_mu, bf16 evals and output.  bfloat16_pure: all bf16.

    impl = ("dense" | "shift", decoder_dtype) decodes through
    `models/dense_decoder.py`, as JAX's `_make_decode_batch` does: the
    eval decode stores its matrices in bf16 when decoder_dtype or the
    tier's eval dtype is bf16, and the output decode is a float32 one
    at the tiers whose output decode is float32 and whose evals are not
    (bfloat16, bfloat16_delta), else the eval decode itself."""
    def at(dtype, head_dtype=None):
        """`model` at these compute dtypes, its weights stored in them."""
        stored = (model.dtype, model.head_dtype,
                  model.decoder_input.weight.dtype, model.fc_mu.weight.dtype)
        if stored == (dtype, head_dtype, dtype, head_dtype or dtype):
            return model
        return model.clone(dtype=dtype, head_dtype=head_dtype)

    f32 = at(torch.float32)
    evals = f32 if tier == "float32" else at(torch.bfloat16)
    if tier == "bfloat16_f32head":
        enc = at(torch.bfloat16, torch.float32)
    elif tier == "bfloat16_pure":
        enc = evals
    else:
        enc = f32
    out = f32 if tier in ("float32", "bfloat16", "bfloat16_delta") else evals
    kind, ddtype = impl
    if kind == "conv":
        dec_eval, dec_out = evals.decode_to_bodypose, out.decode_to_bodypose
    else:
        make = make_dense_decoder if kind == "dense" else make_shift_decoder
        dt = torch.bfloat16 if ddtype == "bfloat16" else evals.dtype
        dec_eval = make(f32, dt)
        dec_out = (make(f32, torch.float32)
                   if tier in ("bfloat16", "bfloat16_delta") else dec_eval)
    return StageModels(tier, enc, evals, out,
                       decoder_layers(model) if fused_decode else None,
                       dec_eval, dec_out, tuple(impl))


def optimize_stage(model: ConvVAE | StageModels, init_pose, heatmaps,
                   mean_bl, camera: fisheye.FisheyeParams,
                   weights: EnergyWeights, use_reproj: bool,
                   cfg: OptimizeConfig, origins=None, full_hw=None,
                   residual: bool = False, draw_row: int = 0
                   ) -> torch.Tensor:
    """One optimisation stage over a batch of windows.

    model: the prior, as `stage_models` built it for cfg.compute_dtype (a
    ConvVAE is converted here, for this stage only).
    init_pose: (W, T, 15, 3) anchor/init poses.  heatmaps: (W, T, 15, h, w)
    full maps, or k x k crops with origins (W, T, 15, 2) as (oy, ox) and
    the full map extent full_hw; None when use_reproj is False.  mean_bl:
    (W, 15).  Returns the decoded optimised poses (W, T, 15, 3): bf16 for
    the tiers whose output decode is bf16 and no residual offset, as in
    the JAX package.

    cfg.compute_dtype picks the tier (`stage_models`).  bfloat16_delta on
    the batched solver iterates dz = z - mu in bf16 from 0 (exact at the
    init); every eval and the output decode see mu + dz in float32.  The
    per-window solver runs that tier with the mixed tier's semantics, as
    the JAX one does.  With solver.fused_decode, stage 1 on crops without
    a residual offset runs kernel 5 (`ops/fused_decode_energy.py`) on the
    float32 weights of the decoder at every tier.

    solver.init='sample' starts from mu plus JAX's normal draw of the
    stage's (W, latent) shape times the prior's std, keyed by
    solver.init_seed (`conv_vae.sample_init`), at the point where JAX's
    stage draws: after the encode, so the residual offset, the delta
    state and every energy branch take the sample as their mu.  The key
    is the same in both stages and for every call; `draw_row` > 0 takes
    the rows of a larger draw from that row on (a rank's windows of a
    draw over every rank's)."""
    w, t = init_pose.shape[0], init_pose.shape[1]
    L = t * J
    s = cfg.solver
    if use_reproj and origins is None and cfg.heatmap_crop > 0:
        raise ValueError("optimize_stage takes crops with their origins; "
                         "the callers crop before windowing")
    if use_reproj:
        if cfg.heatmap_dtype == "bfloat16":
            heatmaps = heatmaps.to(torch.bfloat16)
        heatmaps = heatmaps.contiguous()   # once per stage, not per eval
    sm = model if isinstance(model, StageModels) else stage_models(
        model, cfg.compute_dtype, s.fused_decode and use_reproj,
        decoder_impl(cfg))
    if (sm.tier, sm.impl) != (cfg.compute_dtype, decoder_impl(cfg)):
        raise ValueError(f"stage models built for {sm.tier!r} with decoder "
                         f"{sm.impl}, the config asks for "
                         f"{cfg.compute_dtype!r} with {decoder_impl(cfg)}")
    eval_decode, out_decode = sm.decode_eval, sm.decode_out
    with torch.no_grad():
        mu, log_var = sm.enc.encode(init_pose.reshape(w, t, 3 * J))
        if s.init == "sample":
            mu = sample_init(mu, log_var, s.init_seed, draw_row)
        offset = (init_pose - out_decode(mu)) if residual else None
    latent = mu.shape[-1]
    smoothed = None
    if cfg.energy.soft_smooth > 0.0:
        # the soft-smooth term's anchor: the stage's input smoothed over
        # time, window by window
        smoothed = gaussian_filter1d(init_pose, cfg.input_smooth_sigma, dim=1)
    coupling = float(cfg.energy.overlap_consistency)

    def decode(dec, z):
        """(..., W, latent) -> (..., W, T, 15, 3), plus the offset."""
        lead = z.shape[:-1]
        pose = dec(z.reshape(-1, latent)).reshape(lead + (t, J, 3))
        return pose if offset is None else pose + offset

    def solve_decode(z):
        """The per-window and joint solves' decode: recomputed in the
        backward pass with solver.remat (the activations are not kept)."""
        if s.remat and torch.is_grad_enabled():
            return checkpoint(decode, eval_decode, z, use_reentrant=False)
        return decode(eval_decode, z)

    use_batched = (s.method == "lbfgs_fixed"
                   and (s.fused_energy or s.batched_solver)
                   and smoothed is None and coupling == 0.0)
    # the delta state: the solver iterates dz from 0 in bf16 around the
    # float32 mu; z_eff recentres every probe batch before the decode
    z_init, delta = mu, None
    if cfg.compute_dtype == "bfloat16_delta" and use_batched:
        delta = mu.to(torch.float32)
        z_init = torch.zeros_like(mu, dtype=torch.bfloat16)

    def z_eff(z):
        return z if delta is None else z.to(torch.float32) + delta

    fused = use_batched and s.fused_energy and (
        not use_reproj or origins is not None)
    if fused and use_reproj and s.fused_decode and offset is None:
        if sm.decoder is None:
            raise ValueError("solver.fused_decode needs stage models built "
                             "with fused_decode=True")
        energy = _fused_energy(init_pose, heatmaps, mean_bl, camera, weights,
                               True, cfg, origins, full_hw,
                               decoder=sm.decoder)

        def batch_energy(z3):
            return energy(z_eff(z3).to(torch.float32))
    elif fused:
        energy = _fused_energy(init_pose, heatmaps, mean_bl, camera, weights,
                               use_reproj, cfg, origins, full_hw)

        def batch_energy(z3):
            rr, bb = z3.shape[0], z3.shape[1]
            pose = decode(eval_decode, z_eff(z3)).to(torch.float32)
            return energy(pose.reshape(rr * bb, L, 3).permute(0, 2, 1)
                          .reshape(rr, bb, 3, L).contiguous())
    else:
        def pose_energy(pose):
            return total_energy_from_pose(
                pose.to(torch.float32), init_pose, mean_bl, heatmaps, camera,
                weights, use_reproj, sampling_impl=cfg.sampling_impl,
                origins=origins, full_hw=full_hw, smoothed_pose=smoothed)

        def batch_energy(z):
            return pose_energy(decode(eval_decode, z_eff(z)) if use_batched
                               else solve_decode(z))

    with torch.no_grad():
        if use_batched:
            def vg_batch(z3):
                with torch.enable_grad():
                    z = z3.detach().requires_grad_(True)
                    vals = batch_energy(z)
                    (gz,) = torch.autograd.grad(vals.sum(), z)
                return vals.detach(), gz

            res = lbfgs_minimize_fixed_batched(
                vg_batch, z_init, max_iter=s.max_iter,
                history_size=s.history_size, lr=s.lr,
                step_candidates=tuple(s.step_candidates), unroll=s.unroll)
        elif coupling > 0.0:
            # the joint solve: one problem over the concatenated window
            # latents (one lane of W * latent), the windows coupled on
            # their shared frames
            def joint_loss(zf):
                poses = solve_decode(zf.reshape(zf.shape[:-2] + (w, latent)))
                e = pose_energy(poses).sum(-1) + coupling * \
                    overlap_consistency_energy(poses.to(torch.float32),
                                               cfg.window.stride)
                return e[..., None]

            res = _solve(cfg, joint_loss, mu.reshape(1, w * latent))
            return decode(out_decode, res.x.reshape(w, latent))
        else:
            res = _solve(cfg, batch_energy, mu)
        return decode(out_decode, z_eff(res.x))


def _unflatten_staged_crops(heatmap_seq, origins, cfg: OptimizeConfig):
    """Undo the flat staged-crop layout (..., k*k*J) -> (..., k, k, J).
    No-op for full maps or already 5-D crops (crops are origins.ndim + 1
    dims, flat crops origins.ndim - 1)."""
    if origins is None or heatmap_seq.dim() != origins.dim() - 1:
        return heatmap_seq
    k = cfg.heatmap_crop
    j = heatmap_seq.shape[-1] // (k * k)
    return heatmap_seq.reshape(heatmap_seq.shape[:-1] + (k, k, j))


def _crop_before_windowing(estimated_local, heatmap_seq,
                           camera: fisheye.FisheyeParams,
                           cfg: OptimizeConfig):
    """k x k crops of the raw per-frame maps (..., H, W, J) on the device:
    at the projected estimate after a guard trip (crop_center
    'estimate'), else at each map's peak.  A frame's crop is the same in
    every window that holds it, so cropping comes before windowing.
    -> (crops (..., k, k, J), origins (..., J, 2), full_hw)."""
    if cfg.crop_center == "estimate":
        cen = projected_estimate_centers(
            estimated_local, camera, heatmap_seq.shape[-3],
            heatmap_seq.shape[-2])
        return crop_heatmaps_at_centers_channels_last(
            heatmap_seq, cfg.heatmap_crop, cen)
    return crop_heatmaps_channels_last(heatmap_seq, cfg.heatmap_crop)


def window_chunk_inputs(estimated_local, camera_seq, heatmap_seq, gt_seq,
                        camera: fisheye.FisheyeParams, cfg: OptimizeConfig,
                        origins=None, full_hw=None):
    """Window (and crop before windowing) one chunk's inputs.

    heatmap_seq: (N, H, W, J) raw maps, or (N, k, k, J) / flat (N, k*k*J)
    staged crops with origins (N, J, 2) and full_hw.  Returns (win_local,
    win_cam, win_heat (W, T, J, h, w), win_gt, win_bl, win_org, full_hw),
    all with a leading window axis."""
    seq_len, stride = cfg.window.seq_len, cfg.window.stride
    win_local = slice_windows(estimated_local, seq_len, stride)
    win_cam = slice_windows(camera_seq, seq_len, stride)
    win_gt = slice_windows(gt_seq, seq_len, stride)

    use_reproj = cfg.energy.reproj != 0.0
    win_org = None
    if origins is not None:
        heatmap_seq = _unflatten_staged_crops(heatmap_seq, origins, cfg)
    elif use_reproj and cfg.heatmap_crop > 0:
        heatmap_seq, origins, full_hw = _crop_before_windowing(
            estimated_local, heatmap_seq, camera, cfg)
    if origins is not None:
        win_org = slice_windows(origins, seq_len, stride)     # (W,T,J,2)
    win_heat = slice_windows(heatmap_seq, seq_len, stride).movedim(-1, 2)

    # per-window mean bone length: the chunk-wide mean of the raw estimate
    chunk_bl = mean_bone_lengths(estimated_local)             # (15,)
    win_bl = chunk_bl.expand(win_local.shape[0], J)
    return (win_local, win_cam, win_heat, win_gt, win_bl, win_org,
            full_hw)


class WindowFields(NamedTuple):
    """Per-window solved fields, pre-merge (all (W, T, 15, 3))."""
    est_world: torch.Tensor
    mid_world: torch.Tensor
    mid_local: torch.Tensor
    opt_world: torch.Tensor
    gt: torch.Tensor


def solve_windows(local_model: ConvVAE | StageModels,
                  global_model: ConvVAE | StageModels, win_local,
                  win_cam, win_heat, win_gt, win_bl,
                  camera: fisheye.FisheyeParams, cfg: OptimizeConfig,
                  win_org=None, full_hw=None,
                  draw_row: int = 0) -> WindowFields:
    """Both stages and the coordinate lifts over a batch of windows (no
    cross-window coupling); `draw_row` as `optimize_stage` takes it."""
    local_w, global_w = stage_weights(cfg)
    use_reproj = cfg.energy.reproj != 0.0
    mid_local = optimize_stage(local_model, win_local, win_heat, win_bl,
                               camera, local_w, use_reproj, cfg,
                               origins=win_org, full_hw=full_hw,
                               residual=cfg.energy.local_residual,
                               draw_row=draw_row)
    # world lifts go straight through the per-frame cameras
    # (cam0 . (inv(cam0) . C_i) == C_i); only stage 2's anchor needs the
    # relative hop
    mid_rel = relative_global_pose(mid_local, win_cam)
    cam0 = win_cam[:, 0]
    est_world = transform_pose(win_local, win_cam)
    mid_world = transform_pose(mid_local, win_cam)
    opt_rel = optimize_stage(global_model, mid_rel, None, win_bl, camera,
                             global_w, False, _stage2_cfg(cfg),
                             residual=cfg.energy.global_residual,
                             draw_row=draw_row)
    opt_world = relative_to_global_pose(opt_rel, cam0)
    return WindowFields(est_world, mid_world, mid_local, opt_world, win_gt)


def merge_window_fields(fields: WindowFields, cfg: OptimizeConfig,
                        batch_dims: int = 0) -> ChunkResult:
    """Overlap-merge the solved window fields (*batch, W, T, 15, 3) into
    per-frame sequences: one matrix a field (matmul_merge, the final
    Gaussian smoothing folded into the optimized field's) or the scatter
    mean (`merge_windows`); a smoothing not folded in (one_euro, with
    timestamps (1..n) / 25 in the field's dtype, or a Gaussian after a
    scatter merge) follows the merge, as in the JAX package."""
    stride = cfg.window.stride
    fold = (cfg.final_smooth_sigma
            if (cfg.matmul_merge and cfg.final_smooth
                and cfg.final_smooth_method == "gaussian") else 0.0)

    def mg(x, sigma=0.0):
        if cfg.matmul_merge:
            return merge_windows_matmul(x, stride, sigma,
                                        batch_dims=batch_dims)
        return merge_windows(x, stride, batch_dims=batch_dims)

    merged = ChunkResult(
        estimated=mg(fields.est_world), mid=mg(fields.mid_world),
        mid_local=mg(fields.mid_local),
        optimized=mg(fields.opt_world, fold), gt=mg(fields.gt))
    if cfg.final_smooth and fold == 0.0:
        opt = merged.optimized
        if cfg.final_smooth_method == "one_euro":
            n = opt.shape[batch_dims]
            ts = torch.arange(1, n + 1, dtype=opt.dtype,
                              device=opt.device) / 25.0
            opt = one_euro_filter(ts, opt.movedim(batch_dims, 0)).movedim(
                0, batch_dims)
        else:
            opt = gaussian_filter1d(opt, cfg.final_smooth_sigma,
                                    dim=batch_dims)
        merged = merged._replace(optimized=opt)
    return merged


def optimize_chunk(local_model: ConvVAE | StageModels,
                   global_model: ConvVAE | StageModels,
                   estimated_local, camera_seq, heatmap_seq, gt_seq,
                   camera: fisheye.FisheyeParams, cfg: OptimizeConfig,
                   origins=None, full_hw=None) -> ChunkResult:
    """Both stages over one chunk with per-window solves.

    estimated_local (N, 15, 3), camera_seq (N, 4, 4) cam->world,
    heatmap_seq (N, H, W, 15) raw maps (or staged crops with origins
    (N, 15, 2) and full_hw), gt_seq (N, 15, 3)."""
    check_supported(cfg)
    (win_local, win_cam, win_heat, win_gt, win_bl, win_org,
     full_hw) = window_chunk_inputs(estimated_local, camera_seq,
                                    heatmap_seq, gt_seq, camera, cfg,
                                    origins, full_hw)
    fields = solve_windows(local_model, global_model, win_local, win_cam,
                           win_heat, win_gt, win_bl, camera, cfg,
                           win_org=win_org, full_hw=full_hw)
    return merge_window_fields(fields, cfg)


def make_chunk_optimizer(model: ConvVAE, cfg: OptimizeConfig,
                         camera: fisheye.FisheyeParams):
    """fn(local_variables, global_variables, estimated_local, camera_seq,
    heatmap_seq, gt_seq) -> ChunkResult: `optimize_chunk` at `cfg` and
    `camera` over `model`'s architecture, the priors given as its state
    dicts and loaded into copies of `model` at each call.  The JAX
    package jit-compiles this closure once a chunk length; here it runs
    eagerly, with nothing to compile."""
    check_supported(cfg)

    def prior(state: dict) -> ConvVAE:
        m = copy.deepcopy(model)
        m.load_state_dict(state)
        return m.eval().requires_grad_(False)

    def run(local_variables, global_variables, estimated_local, camera_seq,
            heatmap_seq, gt_seq) -> ChunkResult:
        with torch.no_grad():
            return optimize_chunk(prior(local_variables),
                                  prior(global_variables), estimated_local,
                                  camera_seq, heatmap_seq, gt_seq, camera,
                                  cfg)

    return run


def optimize_chunks_flat(local_model: ConvVAE | StageModels,
                         global_model: ConvVAE | StageModels,
                         estimated_local, camera_seq, heatmap_seq, gt_seq,
                         camera: fisheye.FisheyeParams, cfg: OptimizeConfig,
                         origins=None, full_hw=None,
                         draw_row: int = 0) -> ChunkResult:
    """Optimise many equal-length chunks with the windows of all chunks
    concatenated into one flat solver batch.  All inputs carry a leading
    chunk axis (C, N, ...); heatmap_seq is the raw maps (C, N, H, W, J),
    or staged crops (flat (C, N, k*k*J) or (C, N, k, k, J)) with origins
    (C, N, J, 2) and full_hw.  Returns (C, covered, 15, 3) fields.  The
    sample init draws (C * W, latent) from row `draw_row` on."""
    check_supported(cfg)
    if cfg.energy.overlap_consistency != 0.0:
        raise ValueError(
            "the flat path concatenates the windows of several chunks, so "
            "energy.overlap_consistency would couple chunk boundaries: "
            "solve per chunk (optimize_chunk, or mode='vmap')")
    if (origins is None) != (full_hw is None):
        raise ValueError("origins and full_hw must be supplied together")
    use_reproj = cfg.energy.reproj != 0.0
    c = estimated_local.shape[0]
    seq_len, stride = cfg.window.seq_len, cfg.window.stride

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
        if origins is None and cfg.heatmap_crop > 0:
            heatmap_seq, origins, full_hw = _crop_before_windowing(
                estimated_local, heatmap_seq, camera, cfg)
        heat = _unflatten_staged_crops(heatmap_seq, origins, cfg)
        f_heat = flat(windows_of(heat).movedim(-1, 3))    # (CW,T,J,h,w)
        if origins is not None:
            f_org = flat(windows_of(origins))              # (CW,T,J,2)

    bl = mean_bone_lengths(estimated_local)               # (C, 15)
    bl_flat = bl.repeat_interleave(w_per, dim=0)          # (C*W, 15)
    fields = solve_windows(local_model, global_model, flat(win_local),
                           flat(win_cam), f_heat, flat(win_gt), bl_flat,
                           camera, cfg, win_org=f_org, full_hw=full_hw,
                           draw_row=draw_row)

    return merge_window_fields(
        WindowFields(*(x.reshape((c, w_per) + x.shape[1:]) for x in fields)),
        cfg, batch_dims=1)


def optimize_chunks_batched(local_model: ConvVAE | StageModels,
                            global_model: ConvVAE | StageModels,
                            estimated_local, camera_seq, heatmap_seq,
                            gt_seq, camera: fisheye.FisheyeParams,
                            cfg: OptimizeConfig, origins=None,
                            full_hw=None) -> ChunkResult:
    """Many equal-length chunks, each through the per-chunk pipeline
    (`optimize_chunk`, per-window solves, its own merge and smoothing),
    the fields stacked on a leading chunk axis: what the JAX package's
    vmap over the chunk axis computes, as a loop over chunks.  Inputs as
    for `optimize_chunks_flat`.  The mode that runs
    energy.overlap_consistency, whose coupling stays inside a chunk.
    The sample init draws the same (W, latent) rows for every chunk, as
    JAX's vmap does with its unbatched key."""
    per_chunk = [
        optimize_chunk(local_model, global_model, estimated_local[i],
                       camera_seq[i], heatmap_seq[i], gt_seq[i], camera, cfg,
                       origins=None if origins is None else origins[i],
                       full_hw=full_hw)
        for i in range(estimated_local.shape[0])]
    return ChunkResult(*(torch.stack(f) for f in zip(*per_chunk)))
