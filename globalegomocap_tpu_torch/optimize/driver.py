"""Per-sequence optimisation driver: the two priors, host staging with
the crop-mass guard, and the flat batched solve.

Counterpart of the slice's subset of `globalegomocap_tpu/optimize/
driver.py`: `SequenceOptimizer` (BN folding at construction,
`stage(on_host=True)`, `_cfg_for_coverage`,
`optimize_chunks_batched(mode="flat")`, `run`).  Every derived
configuration is built from the full resolved config, so nothing keys a
cache on a partial view of it.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass, replace
from typing import Any

import numpy as np
import torch

from globalegomocap_tpu_torch.config import OptimizeConfig, with_overrides
from globalegomocap_tpu_torch.data.test_data import TestChunk
from globalegomocap_tpu_torch.device import resolve_device
from globalegomocap_tpu_torch.energy.terms import (
    crop_coverage_np, crop_heatmaps_at_centers_channels_last_np,
    crop_heatmaps_channels_last_np, projected_estimate_centers)
from globalegomocap_tpu_torch.evaluation.metrics import calculate_errors
from globalegomocap_tpu_torch.models.conv_vae import ConvVAE
from globalegomocap_tpu_torch.models.fold_bn import fold_batchnorm
from globalegomocap_tpu_torch.ops import fisheye
from globalegomocap_tpu_torch.optimize.pipeline import (
    ChunkResult, optimize_chunks_flat)


def resolve_camera(cfg: OptimizeConfig) -> fisheye.FisheyeParams:
    """A built-in camera by name (calibration files wait for a later
    slice)."""
    if cfg.camera in ("egosyn", "pose_fisheye"):
        return fisheye.default_camera(cfg.camera)
    raise NotImplementedError(
        f"camera={cfg.camera!r}: calibration files are not ported yet")


def build_model(cfg: OptimizeConfig, use_bn: bool = True) -> ConvVAE:
    p = cfg.prior
    return ConvVAE(in_channels=p.in_channels, out_channels=p.in_channels,
                   latent_dim=p.latent_dim, seq_len=p.seq_len,
                   hidden_dims=tuple(p.hidden_dims), use_bn=use_bn)


@dataclass(frozen=True)
class StagedBatch:
    """Equal-length chunks staged for the solve: tensors on the solve
    device, heat as FLAT (C, F, k*k*J) peak crops, the crop-guard
    coverage resolved on the host."""
    est: Any              # (C, F, 15, 3)
    cams: Any             # (C, F, 4, 4)
    heat: Any             # (C, F, k*k*J) crops (float32 or bfloat16)
    gt: Any               # (C, F, 15, 3)
    n_chunks: int
    crop_coverage: float | None
    origins: Any = None   # (C, F, J, 2) crop origins (oy, ox)
    full_hw: tuple | None = None


class SequenceOptimizer:
    """The local and global priors plus the resolved config.

    model: a ConvVAE giving the architecture; local_state / global_state:
    its state dicts for the two priors.  With cfg.fold_bn the BatchNorms
    fold into the convs here, once.  Runs on `device` (CUDA unless the
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

    def _make(self, model: ConvVAE, state: dict, use_bn: bool) -> ConvVAE:
        m = ConvVAE(model.in_channels, model.out_channels,
                    model.latent_dim, model.seq_len, model.hidden_dims,
                    use_bn=use_bn)
        m.load_state_dict(copy.deepcopy(state))
        return m.to(self.device).eval().requires_grad_(False)

    def _cfg_for_coverage(self, cov: float | None) -> OptimizeConfig:
        """The crop-mass guard: below heatmap_crop_min_mass the crops are
        redone at guard_crop around the projected estimate and, with
        robust_tier_on_guard, the solver switches to its robust tier
        (>= 15 iterations, history >= 10, 4 step candidates)."""
        cfg = self.cfg
        if cov is None or cov >= cfg.heatmap_crop_min_mass:
            return cfg
        if cfg.guard_crop <= 0:
            raise NotImplementedError(
                "guard_crop=0 (the full-map fallback of a tripped crop "
                "guard) is not ported yet")
        cfg = with_overrides(cfg, heatmap_crop=cfg.guard_crop,
                             crop_center="estimate")
        if cfg.robust_tier_on_guard and cfg.solver.method == "lbfgs_fixed":
            cfg = replace(cfg, solver=replace(
                cfg.solver, history_size=max(cfg.solver.history_size, 10),
                max_iter=max(cfg.solver.max_iter, 15),
                step_candidates=(1.0, 0.5, 0.1, 0.02)))
        return cfg

    def stage(self, chunks: list[TestChunk], coverage: float | None = None,
              on_host: bool = True) -> StagedBatch:
        """Crop the maps in numpy (argmax on the float32 maps), resolve
        the crop-mass guard from the same pass (or take `coverage`), cast
        the crops to bf16 when cfg.heatmap_dtype asks, and move the
        stacked fields to the solve device once."""
        if not on_host:
            raise NotImplementedError(
                "stage(on_host=False) (device staging) is not ported yet")
        if not chunks:
            raise ValueError("stage() needs at least one chunk")
        if len({c.n_frames for c in chunks}) != 1:
            raise ValueError("stage() requires equal-length chunks")
        cfg = self.cfg
        kk = cfg.heatmap_crop
        use_reproj = cfg.energy.reproj != 0.0
        if not (kk > 0 and use_reproj):
            raise NotImplementedError(
                "staging without peak crops (heatmap_crop=0 or reproj=0) "
                "is not ported yet")
        guard_on = cfg.heatmap_crop_min_mass > 0
        crops_l, orgs_l, ratios = [], [], []
        for c in chunks:       # per chunk: bounds host temp memory
            cr, org, full_hw, box, total = crop_heatmaps_channels_last_np(
                np.asarray(c.heatmaps), kk)
            crops_l.append(cr.reshape(cr.shape[0], -1))   # flat contract
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
        k = eff.heatmap_crop
        if k != kk or eff.crop_center != "peak":
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
        heat = torch.from_numpy(np.stack(crops_l))
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
            origins=torch.from_numpy(np.stack(orgs_l)).to(dev),
            full_hw=tuple(int(x) for x in full_hw))

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
            return optimize_chunks_flat(
                self.local_model, self.global_model, staged.est,
                staged.cams, staged.heat, staged.gt,
                self._camera.to(self.device), cfg, origins=staged.origins,
                full_hw=staged.full_hw)

    def run(self, chunk: TestChunk, with_metrics: bool = True):
        """Optimise one chunk and (optionally) evaluate it.  Returns
        (errors | None, estimated, mid_local, optimized, gt) as numpy."""
        res = self.optimize_chunks_batched([chunk])
        res = ChunkResult(*(x[0] for x in res))
        errors = None
        if with_metrics:
            errors = {k: v.cpu().numpy() for k, v in calculate_errors(
                res.estimated, res.mid, res.optimized, res.gt).items()}
        return (errors, res.estimated.cpu().numpy(),
                res.mid_local.cpu().numpy(), res.optimized.cpu().numpy(),
                res.gt.cpu().numpy())
