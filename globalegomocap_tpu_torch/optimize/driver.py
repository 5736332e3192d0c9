"""Per-sequence optimisation driver: the two priors, the crop-mass
guard, host staging, the flat batched solve and the per-chunk solve.

Counterpart of `globalegomocap_tpu/optimize/driver.py`:
`SequenceOptimizer` (BN folding at construction, the guard on raw maps
`_crop_coverage`/`_effective_cfg`, `_cfg_for_coverage` with its
`guard_crop` = 0 full-map fallback, `stage(on_host=True)` through the
native host crop, `optimize_chunks_batched(mode="flat")`,
`optimize_chunk`, `run`), and
`optimize_sequence_dir` (its per-chunk loop, with the per-chunk fault
isolation; the batched variant waits for the port of `evaluate_all`) and
`print_summary`.  Every derived configuration is built from the full
resolved config, so nothing keys a cache on a partial view of it.
"""

from __future__ import annotations

import copy
import time
from dataclasses import dataclass, replace
from typing import Any

import numpy as np
import torch

from globalegomocap_tpu_torch.config import OptimizeConfig, with_overrides
from globalegomocap_tpu_torch.data.test_data import (
    TestChunk, list_chunk_dirs, load_test_chunk)
from globalegomocap_tpu_torch.device import resolve_device
from globalegomocap_tpu_torch.energy.terms import (
    crop_coverage_np, crop_heatmaps_at_centers_channels_last_np,
    crop_heatmaps_channels_last_np, projected_estimate_centers)
from globalegomocap_tpu_torch.evaluation.metrics import calculate_errors
from globalegomocap_tpu_torch.models.conv_vae import ConvVAE
from globalegomocap_tpu_torch.models.fold_bn import fold_batchnorm
from globalegomocap_tpu_torch.native.hostcrop import crop_peak_native
from globalegomocap_tpu_torch.ops import fisheye
from globalegomocap_tpu_torch.optimize import pipeline
from globalegomocap_tpu_torch.optimize.pipeline import ChunkResult


def resolve_camera(cfg: OptimizeConfig) -> fisheye.FisheyeParams:
    """A built-in camera by name (calibration files wait for a later
    slice)."""
    if cfg.camera in ("egosyn", "pose_fisheye"):
        return fisheye.default_camera(cfg.camera)
    raise NotImplementedError(
        f"camera={cfg.camera!r}: calibration files are not ported yet")


def build_model(cfg: OptimizeConfig, use_bn: bool = True) -> ConvVAE:
    """The prior's architecture; its compute dtype is bf16 for every bf16
    tier of cfg.compute_dtype (the weights stay float32)."""
    p = cfg.prior
    dtype = torch.bfloat16 if cfg.compute_dtype.startswith("bfloat16") \
        else torch.float32
    return ConvVAE(in_channels=p.in_channels, out_channels=p.in_channels,
                   latent_dim=p.latent_dim, seq_len=p.seq_len,
                   hidden_dims=tuple(p.hidden_dims), use_bn=use_bn,
                   dtype=dtype)


@dataclass(frozen=True)
class StagedBatch:
    """Equal-length chunks staged for the solve: tensors on the solve
    device, heat as FLAT (C, F, k*k*J) peak crops (or the full maps
    (C, F, H, W, J) when no crops are used), the crop-guard coverage
    resolved on the host."""
    est: Any              # (C, F, 15, 3)
    cams: Any             # (C, F, 4, 4)
    heat: Any             # crops or maps (float32 or bfloat16)
    gt: Any               # (C, F, 15, 3)
    n_chunks: int
    crop_coverage: float | None
    origins: Any = None   # (C, F, J, 2) crop origins (oy, ox)
    full_hw: tuple | None = None


class SequenceOptimizer:
    """The local and global priors plus the resolved config.

    model: a ConvVAE giving the architecture; local_state / global_state:
    its state dicts for the two priors.  With cfg.fold_bn the BatchNorms
    fold into the convs here, once, and the priors are cast for
    cfg.compute_dtype here, once (`pipeline.stage_models`): their weights
    are constants of the optimizer.  Runs on `device` (CUDA unless the
    caller passes "cpu")."""

    def __init__(self, model: ConvVAE, local_state: dict,
                 global_state: dict, cfg: OptimizeConfig, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self._camera = resolve_camera(cfg)
        use_bn = model.use_bn
        if cfg.fold_bn and use_bn:
            local_state = fold_batchnorm(local_state)
            global_state = fold_batchnorm(global_state)
            use_bn = False
        self.local_model = self._make(model, local_state, use_bn)
        self.global_model = self._make(model, global_state, use_bn)
        # the priors at cfg.compute_dtype, cast (and, for fused_decode,
        # folded into kernel 5's layout) once here, not once per stage
        tier = cfg.compute_dtype
        self._stages = (
            pipeline.stage_models(self.local_model, tier,
                                  cfg.solver.fused_decode),
            pipeline.stage_models(self.global_model, tier))

    def _make(self, model: ConvVAE, state: dict, use_bn: bool) -> ConvVAE:
        m = ConvVAE(model.in_channels, model.out_channels,
                    model.latent_dim, model.seq_len, model.hidden_dims,
                    use_bn=use_bn, dtype=model.dtype,
                    head_dtype=model.head_dtype)
        m.load_state_dict(copy.deepcopy(state))
        return m.to(self.device).eval().requires_grad_(False)

    def _cfg_for_coverage(self, cov: float | None) -> OptimizeConfig:
        """The crop-mass guard: below heatmap_crop_min_mass the crops are
        redone at guard_crop around the projected estimate, or with
        guard_crop = 0 the solve falls back to the full maps; with
        robust_tier_on_guard the solver also switches to its robust tier
        (>= 15 iterations, history >= 10, 4 step candidates)."""
        cfg = self.cfg
        if cov is None or cov >= cfg.heatmap_crop_min_mass:
            return cfg
        if cfg.guard_crop > 0:
            cfg = with_overrides(cfg, heatmap_crop=cfg.guard_crop,
                                 crop_center="estimate")
        else:
            cfg = with_overrides(cfg, heatmap_crop=0)
        if cfg.robust_tier_on_guard and cfg.solver.method == "lbfgs_fixed":
            cfg = replace(cfg, solver=replace(
                cfg.solver, history_size=max(cfg.solver.history_size, 10),
                max_iter=max(cfg.solver.max_iter, 15),
                step_candidates=(1.0, 0.5, 0.1, 0.02)))
        return cfg

    def _guard_on(self) -> bool:
        cfg = self.cfg
        return (cfg.heatmap_crop > 0 and cfg.heatmap_crop_min_mass > 0
                and cfg.energy.reproj != 0.0)

    def _crop_coverage(self, heatmaps) -> float | None:
        """The guard statistic on raw maps (N, H, W, J): the mean share of
        non-negative map mass the k x k peak crops keep (numpy, the same
        statistic as the staging pass).  None where the guard does not
        apply."""
        if not self._guard_on():
            return None
        _, _, _, box, total = crop_heatmaps_channels_last_np(
            np.asarray(heatmaps), self.cfg.heatmap_crop)
        return float(crop_coverage_np(box, total))

    def _effective_cfg(self, heatmaps) -> OptimizeConfig:
        """The guard measured on raw maps and applied in one step."""
        return self._cfg_for_coverage(self._crop_coverage(heatmaps))

    def stage(self, chunks: list[TestChunk], coverage: float | None = None,
              on_host: bool = True) -> StagedBatch:
        """Crop the maps on the host with the native kernel
        (`native/hostcrop.c`: one pass a chunk, argmax on the float32
        maps), resolve the crop-mass guard from its box and total sums (or
        take `coverage`), cast the staged heat to bf16 when
        cfg.heatmap_dtype asks, and move the stacked fields to the solve
        device once.  Without crops (heatmap_crop = 0, reproj = 0, or a
        tripped guard with guard_crop = 0) the full maps are staged."""
        if not on_host:
            raise NotImplementedError(
                "stage(on_host=False) (device staging) is not ported yet")
        if not chunks:
            raise ValueError("stage() needs at least one chunk")
        if len({c.n_frames for c in chunks}) != 1:
            raise ValueError("stage() requires equal-length chunks; use "
                             "optimize_chunk per chunk or "
                             "optimize_sequence_dir for mixed lengths")
        cfg = self.cfg
        kk = cfg.heatmap_crop
        use_reproj = cfg.energy.reproj != 0.0
        guard_on = self._guard_on()
        crops_l, orgs_l, ratios = [], [], []
        full_hw = None
        if kk > 0 and use_reproj:
            for c in chunks:   # per chunk: bounds host temp memory
                cr, org, full_hw, box, total = crop_peak_native(c.heatmaps,
                                                                kk)
                crops_l.append(cr)                 # the flat layout
                orgs_l.append(org)
                if guard_on and coverage is None:
                    ratios.append(crop_coverage_np(box, total))
        if coverage is not None:
            cov = coverage
        elif guard_on:
            cov = float(np.mean(ratios))
        else:
            cov = None
        eff = self._cfg_for_coverage(cov)
        k = eff.heatmap_crop if use_reproj else 0
        if k > 0 and (k != kk or eff.crop_center != "peak"):
            # guard-trip path: re-crop at the projected-estimate centres
            hh, ww = np.asarray(chunks[0].heatmaps).shape[-3:-1]
            crops_l, orgs_l = [], []
            for c in chunks:
                cen = projected_estimate_centers(
                    torch.from_numpy(np.asarray(c.estimated_local)),
                    self._camera, hh, ww).numpy()
                cr, org, full_hw = crop_heatmaps_at_centers_channels_last_np(
                    np.asarray(c.heatmaps), k, cen)
                crops_l.append(cr.reshape(cr.shape[0], -1))
                orgs_l.append(org)
        if k > 0:
            heat = torch.from_numpy(np.stack(crops_l))
            origins = torch.from_numpy(np.stack(orgs_l))
            full_hw = tuple(int(x) for x in full_hw)
        else:        # no crops, or a tripped guard with guard_crop = 0
            heat = torch.from_numpy(np.stack(
                [np.asarray(c.heatmaps, dtype=np.float32) for c in chunks]))
            origins, full_hw = None, None
        if cfg.heatmap_dtype == "bfloat16":
            heat = heat.to(torch.bfloat16)     # after the f32 argmax
        stack = lambda name: torch.from_numpy(np.stack(  # noqa: E731
            [np.asarray(getattr(c, name), dtype=np.float32)
             for c in chunks]))
        dev = self.device
        return StagedBatch(
            est=stack("estimated_local").to(dev),
            cams=stack("camera_poses").to(dev),
            heat=heat.to(dev),
            gt=stack("gt_global").to(dev),
            n_chunks=len(chunks), crop_coverage=cov,
            origins=None if origins is None else origins.to(dev),
            full_hw=full_hw)

    def optimize_chunks_batched(self, chunks, mode: str = "flat"
                                ) -> ChunkResult:
        """Solve a StagedBatch (or a list of equal-length chunks, staged
        here) as one flat batch of windows.  Returns a ChunkResult with a
        leading chunk axis."""
        if mode != "flat":
            raise NotImplementedError(
                f"mode={mode!r}: only the flat batched path is ported")
        staged = chunks if isinstance(chunks, StagedBatch) \
            else self.stage(chunks)
        cfg = self._cfg_for_coverage(staged.crop_coverage)
        with torch.no_grad():
            return pipeline.optimize_chunks_flat(
                *self._stages, staged.est,
                staged.cams, staged.heat, staged.gt,
                self._camera.to(self.device), cfg, origins=staged.origins,
                full_hw=staged.full_hw)

    def optimize_chunk(self, chunk: TestChunk,
                       cfg: OptimizeConfig | None = None) -> ChunkResult:
        """Optimise one chunk with per-window solves: the crop guard runs
        on its raw maps (unless `cfg`, an already resolved config, is
        given) and the crops are cut on the device inside the solve."""
        if cfg is None:
            cfg = self._effective_cfg(chunk.heatmaps)
        dev = self.device
        f32 = lambda x: torch.as_tensor(  # noqa: E731
            np.asarray(x, dtype=np.float32), device=dev)
        with torch.no_grad():
            return pipeline.optimize_chunk(
                *self._stages, f32(chunk.estimated_local),
                f32(chunk.camera_poses), f32(chunk.heatmaps),
                f32(chunk.gt_global),
                self._camera.to(dev), cfg)

    def run(self, chunk: TestChunk, with_metrics: bool = True):
        """Optimise one chunk (`optimize_chunk`) and optionally evaluate
        it.  Returns (errors | None, estimated, mid_local, optimized, gt)
        as numpy, the tuple of the reference's `optimizer.main`, at every
        tier.  A bf16 field (mid_local, at the tiers whose output decode
        is bf16) is widened to float32, which is exact: numpy has no
        bf16, and the JAX package's bf16 arrays need `ml_dtypes`."""
        res = self.optimize_chunk(chunk)
        errors = None
        if with_metrics:
            errors = {k: _numpy(v) for k, v in calculate_errors(
                res.estimated, res.mid, res.optimized, res.gt).items()}
        return (errors, _numpy(res.estimated), _numpy(res.mid_local),
                _numpy(res.optimized), _numpy(res.gt))


def _numpy(x: torch.Tensor) -> np.ndarray:
    """A tensor as a numpy array on the host, bf16 widened to float32."""
    if x.dtype == torch.bfloat16:
        x = x.to(torch.float32)
    return x.cpu().numpy()


def _regression_tripwire(errors: dict) -> None:
    """The reference driver prints a chunk whose bone-length-aligned
    error got worse in stage 2."""
    if errors["bone_length_aligned_optimized_mpjpe"] > \
            errors["bone_length_aligned_mid_optimized_mpjpe"]:
        print(errors)


def optimize_sequence_dir(opt: SequenceOptimizer, data_dir: str,
                          verbose: bool = True):
    """Optimise every chunk directory of a sequence, one chunk at a time,
    and average the metrics.  A chunk that fails to load or solve is
    skipped and listed in timing["failed_chunks"], so one bad chunk does
    not end the sequence.  Returns (per_chunk_errors, averages,
    timing)."""
    all_errors, timings, failures = [], [], []
    for chunk_dir in list_chunk_dirs(data_dir):
        try:
            chunk = load_test_chunk(chunk_dir)
            t0 = time.perf_counter()
            errors, *_ = opt.run(chunk)         # numpy: already synced
            dt = time.perf_counter() - t0
        except Exception as e:  # noqa: BLE001 - isolate a failing chunk
            failures.append((chunk_dir, repr(e)))
            if verbose:
                print(f"SKIPPED corrupt chunk {chunk_dir}: {e!r}")
            continue
        timings.append(dt)
        all_errors.append(errors)
        if verbose:
            print(f"running data: {chunk_dir}")
            _regression_tripwire(errors)

    averages = {}
    if all_errors:
        for k in all_errors[0]:
            averages[k] = np.mean([e[k] for e in all_errors], axis=0)
    timing = {"total_s": float(np.sum(timings)),
              "per_chunk_s": float(np.mean(timings)) if timings else 0.0,
              "failed_chunks": failures}
    if verbose and averages:
        print_summary(averages)
        print(f"total optimization time: {timing['total_s']:.2f}s")
    return all_errors, averages, timing


def print_summary(avg: dict):
    """The reference driver's summary block, same quantities."""
    sep = "-----------------------------------------"
    print(f"Average original global pose mpjpe: {avg['original_global_mpjpe']}")
    print(f"Average mid global pose mpjpe: {avg['mid_global_mpjpe']}")
    print(f"Average optimized global pose mpjpe: {avg['optimized_global_mpjpe']}")
    print(sep)
    print(f"Average original cam pose error: {avg['original_camera_pos_error']}")
    print(f"Average optimized cam pose error: {avg['optimized_camera_pos_error']}")
    print(sep)
    print(f"Average original aligned cam pose error: {avg['original_aligned_camera_pos_error']}")
    print(f"Average optimized aligned cam pose error: {avg['optimized_aligned_camera_pos_error']}")
    print(sep)
    print(f"Average original_aligned_global_mpjpe: {avg['original_aligned_global_mpjpe']}")
    print(f"Average aligned_mid_seq_mpjpe: {avg['aligned_mid_seq_mpjpe']}")
    print(f"Average optimized_aligned_global_mpjpe: {avg['optimized_aligned_global_mpjpe']}")
    print(sep)
    print(f"Average aligned original global pose mpjpe: {avg['aligned_original_mpjpe']}")
    print(f"Average aligned mid local pose mpjpe: {avg['aligned_mid_optimized_mpjpe']}")
    print(f"Average aligned optimized global pose mpjpe: {avg['aligned_optimized_mpjpe']}")
    print(sep)
    print(f"Average bone length aligned original global pose mpjpe: {avg['bone_length_aligned_original_mpjpe']}")
    print(f"Average bone length aligned mid local pose mpjpe: {avg['bone_length_aligned_mid_optimized_mpjpe']}")
    print(f"Average bone length aligned optimized global pose mpjpe: {avg['bone_length_aligned_optimized_mpjpe']}")
    print(sep)
    print(f"joints error is: {avg['joints_error']}")
