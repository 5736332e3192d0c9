"""Per-sequence optimisation driver: the two priors, the crop-mass
guard, host staging, the flat batched solve and the per-chunk solve.

Counterpart of `globalegomocap_tpu/optimize/driver.py`:
`SequenceOptimizer` (BN folding at construction, the guard on raw maps
`_crop_coverage`/`_effective_cfg`, `_cfg_for_coverage` with its
`guard_crop` = 0 full-map fallback, `stage` on the host through the
native host crop or on the device, `optimize_chunks_batched` in its
modes 'flat' and 'vmap', `optimize_chunk`, `run`, and the selection among
the prior pairs of a `prior_bank` by each batch's motion statistic), and
`optimize_sequence_dir` (its per-chunk loop with the per-chunk fault
isolation, or with batched=True one staged flat solve a sequence, as
`cli/evaluate_all.py` runs it), `print_summary` and
`load_priors_from_torch`.  Every derived
configuration is built from the full resolved config, so nothing keys a
cache on a partial view of it.

Over a mesh of several ranks (`parallel/mesh.py`; `make_mesh()` at
construction, one rank without a process group) the chunk axis is
sharded as the JAX driver shards it over its devices: staging edge-pads
the chunks to a multiple of the mesh size and each rank stages only its
own slice, `optimize_chunks_batched` solves each rank's slice with no
collective and gathers the ChunkResult once, and `optimize_chunk_sharded`
shards one chunk's windows (`parallel/window_shard.py`).  A mesh of one
rank pads nothing and makes no collective call.

On the card a warm `optimize_chunks_batched(staged)` waits for nothing:
the solve's constants (the camera, the weight rows, the window and merge
tables, the step lengths) are built on the device once, so the call only
queues work and request t+1 can be dispatched while request t solves.
Staging copies through pinned host buffers without blocking, on the
caller's current stream; a batch staged on another stream (the
`streaming.StagePrefetcher`'s) carries an event that the solve's stream
waits on.
"""

from __future__ import annotations

import copy
import time
import warnings
from dataclasses import dataclass, replace
from typing import Any

import numpy as np
import torch

from globalegomocap_tpu_torch.config import OptimizeConfig, with_overrides
from globalegomocap_tpu_torch.data.test_data import (
    TestChunk, list_chunk_dirs, load_test_chunk)
from globalegomocap_tpu_torch.energy.terms import (
    crop_coverage_mean, crop_coverage_np,
    crop_heatmaps_at_centers_channels_last,
    crop_heatmaps_at_centers_channels_last_np, crop_heatmaps_channels_last,
    crop_heatmaps_channels_last_np, projected_estimate_centers)
from globalegomocap_tpu_torch.evaluation.metrics import calculate_errors
from globalegomocap_tpu_torch.models.conv_vae import ConvVAE
from globalegomocap_tpu_torch.models.fold_bn import fold_batchnorm
from globalegomocap_tpu_torch.native.hostcrop import crop_peak_native
from globalegomocap_tpu_torch.ops import fisheye
from globalegomocap_tpu_torch.optimize import pipeline
from globalegomocap_tpu_torch.optimize.pipeline import ChunkResult
from globalegomocap_tpu_torch.optimize.prior_bank import (
    PriorBank, motion_accel_stat, motion_accel_stat_torch, nearest_index)
from globalegomocap_tpu_torch.optimize.window import num_windows
from globalegomocap_tpu_torch.parallel.mesh import (
    Mesh, all_gather_fields, all_reduce, broadcast_object, make_mesh,
    pad_to_multiple, shard_batch)
from globalegomocap_tpu_torch.parallel.window_shard import (
    optimize_chunk_window_sharded)


def resolve_camera(cfg: OptimizeConfig) -> fisheye.FisheyeParams:
    """The camera from a built-in name or a calibration JSON path."""
    if cfg.camera in ("egosyn", "pose_fisheye"):
        return fisheye.default_camera(cfg.camera)
    return fisheye.load_calibration(cfg.camera)


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
    resolved to a host scalar.  `accel_mean`: the estimates' motion
    statistic (`prior_bank.motion_accel_stat`), measured only when the
    optimizer has a prior bank or a recorded prior statistic.  `ready`:
    None when the tensors were written on the stream that solves them,
    else a CUDA event recorded on the staging stream after the last
    write."""
    est: Any              # (C, F, 15, 3)
    cams: Any             # (C, F, 4, 4)
    heat: Any             # crops or maps (float32 or bfloat16)
    gt: Any               # (C, F, 15, 3)
    n_chunks: int
    crop_coverage: float | None
    origins: Any = None   # (C, F, J, 2) crop origins (oy, ox)
    full_hw: tuple | None = None
    accel_mean: float | None = None
    ready: Any = None     # torch.cuda.Event | None

    def tensors(self) -> tuple:
        return tuple(t for t in (self.est, self.cams, self.heat, self.gt,
                                 self.origins) if t is not None)


class SequenceOptimizer:
    """The local and global priors plus the resolved config.

    model: a ConvVAE giving the architecture; local_state / global_state:
    its state dicts for the two priors.  With cfg.fold_bn the BatchNorms
    fold into the convs here, once, and the priors are cast for
    cfg.compute_dtype here, once (`pipeline.stage_models`): their weights
    are constants of the optimizer.  Runs on `device` (CUDA unless the
    caller passes "cpu").

    Prior-regime matching (`optimize/prior_bank.py`), off by default as
    in the reference: with `prior_bank` each staged batch (and each chunk
    of `optimize_chunk`) is measured and solved with the bank's pair
    nearest its statistic (`last_prior_name` names it); every entry is
    folded and cast here, once, like the held pair, so a batch only swaps
    which staged pair it solves with.  Without a bank, `prior_accel_mean`
    (the held priors' training statistic, the trainer's
    `motion_stats["accel_mean"]`) warns once when a batch's statistic is
    more than `mismatch_warn_ratio` times off, either way.

    `mesh` (default `make_mesh(device=device)`; its device is the solve
    device) shards the batched solve's chunk axis over its ranks."""

    def __init__(self, model: ConvVAE, local_state: dict,
                 global_state: dict, cfg: OptimizeConfig, device=None,
                 prior_bank: PriorBank | None = None,
                 prior_accel_mean: float | None = None,
                 mismatch_warn_ratio: float = 2.0,
                 mesh: Mesh | None = None):
        self.cfg = cfg
        self.mesh = mesh or make_mesh(device=device)
        self.device = self.mesh.device
        self._camera = resolve_camera(cfg)
        self._camera_dev = self._camera.to(self.device)
        self.prior_accel_mean = prior_accel_mean
        self.mismatch_warn_ratio = mismatch_warn_ratio
        self.last_prior_name: str | None = None
        self._warned_mismatch = False
        self.local_model, self.global_model, self._stages = \
            self._stage_pair(model, local_state, global_state)
        # the bank as it is now, each entry staged: its names, statistics
        # and StageModels pairs (an entry added to the caller's bank later
        # is not staged, and the entries' state dicts are not kept)
        self._bank = None if prior_bank is None else [
            (e.name, e.accel_mean, self._stage_pair(
                model, e.local_variables, e.global_variables)[2])
            for e in prior_bank.entries]

    def _stage_pair(self, model: ConvVAE, local_state: dict,
                    global_state: dict):
        """(local model, global model, their StageModels): a prior pair
        BN-folded (with cfg.fold_bn), on the device and cast for
        cfg.compute_dtype (and, for fused_decode, folded into kernel 5's
        layout) once, not once per stage."""
        cfg = self.cfg
        use_bn = model.use_bn
        if cfg.fold_bn and use_bn:
            local_state = fold_batchnorm(local_state)
            global_state = fold_batchnorm(global_state)
            use_bn = False
        local_model = self._make(model, local_state, use_bn)
        global_model = self._make(model, global_state, use_bn)
        tier, impl = cfg.compute_dtype, pipeline.decoder_impl(cfg)
        return local_model, global_model, (
            pipeline.stage_models(local_model, tier,
                                  cfg.solver.fused_decode, impl),
            pipeline.stage_models(global_model, tier, impl=impl))

    def _accel_stat(self, est) -> float | None:
        """The motion statistic of a staged (C, F, 15, 3) estimate stack,
        at the prior's seq_len window (the resolution of the priors'
        training windows): numpy for a host array, on the device for a
        tensor (one scalar read back, after the current stream's writes
        of `est`).  None unless prior matching is configured."""
        if self._bank is None and self.prior_accel_mean is None:
            return None
        win = self.cfg.prior.seq_len
        if isinstance(est, np.ndarray):
            return motion_accel_stat(est, window=win)
        return float(motion_accel_stat_torch(est, window=win))

    def _select_priors(self, accel_mean: float | None) -> tuple:
        """The StageModels pair to solve a batch of statistic
        `accel_mean` with: the bank's nearest pair, or the held pair
        (warning once if it was trained on another motion regime).  The
        held pair also solves a batch staged without a statistic (by an
        optimizer with no bank), as in the JAX package."""
        if accel_mean is None:
            return self._stages
        if self._bank is not None:
            i = nearest_index([a for _, a, _ in self._bank], accel_mean)
            self.last_prior_name, _, stages = self._bank[i]
            return stages
        if self.prior_accel_mean and not self._warned_mismatch:
            r = accel_mean / self.prior_accel_mean
            if r > self.mismatch_warn_ratio or \
                    r < 1.0 / self.mismatch_warn_ratio:
                warnings.warn(
                    f"prior/input motion-regime mismatch: batch accel "
                    f"{accel_mean:.2e} vs prior training accel "
                    f"{self.prior_accel_mean:.2e} ({r:.1f}x) — the prior "
                    f"was trained on a different motion regime; consider "
                    f"a matched prior (optimize/prior_bank.py)",
                    stacklevel=3)
                self._warned_mismatch = True
        return self._stages

    def _make(self, model: ConvVAE, state: dict, use_bn: bool) -> ConvVAE:
        m = ConvVAE(model.in_channels, model.out_channels,
                    model.latent_dim, model.seq_len, model.hidden_dims,
                    use_bn=use_bn, dtype=model.dtype,
                    head_dtype=model.head_dtype,
                    with_bone_length=model.with_bone_length)
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
              on_host: bool = False) -> StagedBatch:
        """Stage equal-length chunks for the solve, on the caller's current
        stream: the peak crops (argmax on the float32 maps), the crop-mass
        guard resolved from them (or `coverage`, taken as given), the
        estimate-centred re-crop of a tripped guard, the cast of the
        staged heat to bf16 when cfg.heatmap_dtype asks, and the stacked
        fields on the solve device.  Without crops (heatmap_crop = 0,
        reproj = 0, or a tripped guard with guard_crop = 0) the full maps
        are staged.

        on_host=True crops on the host with the native kernel
        (`native/hostcrop.c`), so only the crops cross to the device.
        on_host=False (the JAX default) moves each chunk's full maps to
        the device once and crops there (`_stage_device`); the two are
        bit-identical (crops and origins; the coverage within float32
        rounding, 1e-6 relative).

        Over a mesh of several ranks the chunk axis is edge-padded to a
        multiple of the mesh size and each rank stages only its own slice
        of it (`n_chunks` stays the unpadded count).  The guard's coverage
        is the mean over the unpadded chunks (each rank's sum over its
        real chunks, summed over the ranks), and the motion statistic is
        taken on the host over the padded stack, as in the JAX driver,
        where duplicated edge chunks weigh in."""
        if not chunks:
            raise ValueError("stage() needs at least one chunk")
        if len({c.n_frames for c in chunks}) != 1:
            raise ValueError("stage() requires equal-length chunks; use "
                             "optimize_chunk per chunk or "
                             "optimize_sequence_dir for mixed lengths")
        n = len(chunks)
        if self.mesh.size == 1:
            local, n_real = chunks, n
        else:
            idx = shard_batch(self.mesh,
                              pad_to_multiple(np.arange(n), self.mesh.size)[0])
            local = [chunks[i] for i in idx]
            # the padding repeats the last chunk at the end of the axis
            n_real = min(max(n - self.mesh.rank * len(idx), 0), len(idx))
        staged = (self._stage_host if on_host else self._stage_device)(
            local, coverage, n_real)
        if self.mesh.size == 1:
            return staged
        est = pad_to_multiple(_stack(chunks, "estimated_local"),
                              self.mesh.size)[0]
        return replace(staged, n_chunks=n, accel_mean=self._accel_stat(est))

    def _mean_over_ranks(self, total, count: int) -> float:
        """A mean over every rank's real chunks from this rank's `total`
        over its `count` real chunks (one all_reduce, on the mesh's
        staging group: staging may run on a prefetch thread while the
        solve gathers on the world group)."""
        t = torch.stack([torch.as_tensor(total, dtype=torch.float64).cpu(),
                         torch.tensor(float(count), dtype=torch.float64)])
        t = all_reduce(self.mesh.staging(), t)
        return float(t[0] / t[1])

    def _stage_host(self, chunks: list[TestChunk], coverage: float | None,
                    n_real: int) -> StagedBatch:
        """stage(on_host=True) of this rank's chunks (the first `n_real`
        of them real, the rest padding)."""
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
        elif guard_on and self.mesh.size == 1:
            cov = float(np.mean(ratios))
        elif guard_on:
            cov = self._mean_over_ranks(float(np.sum(ratios[:n_real])),
                                        n_real)
        else:
            cov = None
        eff = self._cfg_for_coverage(cov)
        k = eff.heatmap_crop if use_reproj else 0
        if k > 0 and (k != kk or eff.crop_center != "peak"):
            # guard-trip path: re-crop at the projected-estimate centres
            hh, ww = np.asarray(chunks[0].heatmaps).shape[-3:-1]
            crops_l, orgs_l = [], []
            for c in chunks:
                cr, org, full_hw = crop_heatmaps_at_centers_channels_last_np(
                    np.asarray(c.heatmaps), k,
                    self._estimate_centers(c, hh, ww))
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
        est = _stack(chunks, "estimated_local")
        return StagedBatch(
            est=self._put(est),
            cams=self._put(_stack(chunks, "camera_poses")),
            heat=self._put(heat), gt=self._put(_stack(chunks, "gt_global")),
            n_chunks=len(chunks), crop_coverage=cov,
            origins=None if origins is None else self._put(origins),
            full_hw=full_hw, accel_mean=(self._accel_stat(est)
                                         if self.mesh.size == 1 else None))

    def _stage_device(self, chunks: list[TestChunk],
                      coverage: float | None, n_real: int) -> StagedBatch:
        """stage(on_host=False) of this rank's chunks (the first `n_real`
        of them real): each chunk's full maps go to the device once; the
        crops are cut there (`crop_heatmaps_channels_last`, a gather: the
        JAX package's `stage_crop_impl="onehot"` is a TPU matmul trick for
        the same selection) over segments of cfg.stage_segment_chunks
        chunks, as the JAX driver segments its staging program; the
        guard's coverage is computed on the device (`crop_coverage_mean`)
        and read back once for the batch.  The estimate centres of a
        tripped guard come from the host estimates, as in host staging,
        so both stagings cut the same crops."""
        cfg = self.cfg
        kk = cfg.heatmap_crop
        use_reproj = cfg.energy.reproj != 0.0
        maps = [self._put(np.asarray(c.heatmaps, dtype=np.float32))
                for c in chunks]
        seg = cfg.stage_segment_chunks
        n = len(chunks)
        parts = ([list(range(i, min(i + seg, n))) for i in range(0, n, seg)]
                 if seg and n > seg else [list(range(n))])
        cov = coverage
        if coverage is None and self._guard_on():
            # equal-length chunks: the mean of the segments' means,
            # weighted by their sizes, is the mean over every map
            real = [q for q in ([i for i in p if i < n_real] for p in parts)
                    if q]
            total = sum(crop_coverage_mean(torch.stack([maps[i] for i in p])
                                           .movedim(-1, -3), kk) * len(p)
                        for p in real)
            cov = (float(total / n) if self.mesh.size == 1
                   else self._mean_over_ranks(total, n_real))
        eff = self._cfg_for_coverage(cov)
        k = eff.heatmap_crop if use_reproj else 0
        full_hw = tuple(maps[0].shape[-3:-1]) if k > 0 else None
        crops_l, orgs_l = [], []
        for p in parts:
            if k <= 0:
                crops_l.append(torch.stack([maps[i] for i in p]))
                continue
            if eff.crop_center == "peak":
                cr, org, _ = crop_heatmaps_channels_last(
                    torch.stack([maps[i] for i in p]), k)
            else:
                hh, ww = full_hw
                cen = torch.from_numpy(np.stack([
                    self._estimate_centers(chunks[i], hh, ww) for i in p]))
                cr, org, _ = crop_heatmaps_at_centers_channels_last(
                    torch.stack([maps[i] for i in p]), k,
                    self._put(cen))
            crops_l.append(cr.reshape(cr.shape[:2] + (-1,)))
            orgs_l.append(org)
        heat = torch.cat(crops_l)
        if cfg.heatmap_dtype == "bfloat16":
            heat = heat.to(torch.bfloat16)     # after the f32 argmax
        est = self._put(_stack(chunks, "estimated_local"))
        return StagedBatch(
            est=est, cams=self._put(_stack(chunks, "camera_poses")),
            heat=heat, gt=self._put(_stack(chunks, "gt_global")),
            n_chunks=n, crop_coverage=cov,
            origins=torch.cat(orgs_l) if orgs_l else None, full_hw=full_hw,
            accel_mean=(self._accel_stat(est) if self.mesh.size == 1
                        else None))

    def _estimate_centers(self, chunk: TestChunk, h: int, w: int):
        """The guard-trip crop centres (F, J, 2) of one chunk, from its
        host estimates on the host camera (numpy)."""
        return projected_estimate_centers(
            torch.from_numpy(np.asarray(chunk.estimated_local,
                                        dtype=np.float32)),
            self._camera, h, w).numpy()

    def _put(self, x) -> torch.Tensor:
        """A host array or tensor on the solve device: on the card through
        pinned memory, without blocking, on the current stream (the
        caching host allocator keeps the pinned block until the copy is
        done)."""
        t = torch.from_numpy(np.ascontiguousarray(x)) \
            if isinstance(x, np.ndarray) else x
        if self.device.type != "cuda":
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    def _consume(self, staged: StagedBatch) -> None:
        """Make the current stream wait for a batch staged on another
        stream, and tell the caching allocator that this stream reads its
        tensors."""
        if staged.ready is None:
            return
        stream = torch.cuda.current_stream(self.device)
        stream.wait_event(staged.ready)
        for t in staged.tensors():
            t.record_stream(stream)

    def optimize_chunks_batched(self, chunks, mode: str = "vmap"
                                ) -> ChunkResult:
        """Solve a StagedBatch (or a list of equal-length chunks, staged
        here): mode='flat' as one flat batch of windows (the serving
        path), mode='vmap' (the JAX default) chunk by chunk through the
        per-chunk pipeline (`pipeline.optimize_chunks_batched`).  Returns
        a ChunkResult with a leading chunk axis.

        Over a mesh of several ranks each rank solves its staged slice
        with no collective (the JAX driver's shard_map), then one
        all_gather collects the ChunkResult, sliced to the unpadded
        chunks; every rank returns the whole result.

        The sample init (solver.init='sample') draws what the JAX
        driver's program draws on each device.  Where it runs shard_map
        (several ranks with solver.fused_energy or batched_solver) every
        rank draws at its own shape, so its rows repeat rank 0's; where it
        runs one program sharded by jit (several ranks and neither flag)
        the flat mode draws once over every rank's windows and each rank
        takes its rows of that draw.  The vmap mode draws the same rows
        for every chunk either way."""
        if mode not in ("flat", "vmap"):
            raise ValueError(f"mode={mode!r}: 'flat' or 'vmap'")
        staged = chunks if isinstance(chunks, StagedBatch) \
            else self.stage(chunks)
        size = self.mesh.size
        if staged.est.shape[0] != -(-staged.n_chunks // size):
            raise ValueError(
                f"a batch of {staged.n_chunks} chunks staged as "
                f"{staged.est.shape[0]} a rank: it was staged for another "
                f"mesh than this optimizer's {size} rank(s)")
        self._consume(staged)
        cfg = self._cfg_for_coverage(staged.crop_coverage)
        solve = (pipeline.optimize_chunks_flat if mode == "flat"
                 else pipeline.optimize_chunks_batched)
        stages = self._select_priors(staged.accel_mean)
        kw = {}
        if mode == "flat" and size > 1 and not (
                cfg.solver.fused_energy or cfg.solver.batched_solver):
            per_chunk = num_windows(staged.est.shape[1], cfg.window.seq_len,
                                    cfg.window.stride)
            kw["draw_row"] = self.mesh.rank * staged.est.shape[0] * per_chunk
        with torch.no_grad():
            res = solve(*stages, staged.est, staged.cams, staged.heat,
                        staged.gt, self._camera_dev, cfg,
                        origins=staged.origins, full_hw=staged.full_hw, **kw)
            if size == 1:
                return res
            return ChunkResult(*(f[:staged.n_chunks] for f in
                                 all_gather_fields(self.mesh, res)))

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
        stages = self._select_priors(self._accel_stat(
            np.asarray(chunk.estimated_local, dtype=np.float32)))
        with torch.no_grad():
            return pipeline.optimize_chunk(
                *stages, f32(chunk.estimated_local),
                f32(chunk.camera_poses), f32(chunk.heatmaps),
                f32(chunk.gt_global),
                self._camera_dev, cfg)

    def optimize_chunk_sharded(self, chunk: TestChunk,
                               cfg: OptimizeConfig | None = None
                               ) -> ChunkResult:
        """Optimise one chunk with its window axis sharded over this
        optimizer's mesh: the path that gives one long sequence
        more than one card (`parallel/window_shard.py`).  The guard and
        the prior pair are resolved as in `optimize_chunk`; on a mesh of
        one rank it is `optimize_chunk`."""
        if cfg is None:
            cfg = self._effective_cfg(chunk.heatmaps)
        dev = self.device
        f32 = lambda x: torch.as_tensor(  # noqa: E731
            np.asarray(x, dtype=np.float32), device=dev)
        stages = self._select_priors(self._accel_stat(
            np.asarray(chunk.estimated_local, dtype=np.float32)))
        with torch.no_grad():
            return optimize_chunk_window_sharded(
                *stages, f32(chunk.estimated_local),
                f32(chunk.camera_poses), f32(chunk.heatmaps),
                f32(chunk.gt_global), self._camera_dev, cfg,
                mesh=self.mesh)

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


def load_priors_from_torch(cfg: OptimizeConfig, local_ckpt: str,
                           global_ckpt: str, device=None
                           ) -> SequenceOptimizer:
    """A SequenceOptimizer of `cfg` on two reference-format priors
    (.pth.tar training checkpoints or bare torch state dicts, read by
    `cli/serve.py::load_state` and checked against the model), on
    `device` (CUDA unless the caller passes "cpu")."""
    from globalegomocap_tpu_torch.cli.serve import load_state
    model = build_model(cfg)
    return SequenceOptimizer(model, load_state(local_ckpt, model),
                             load_state(global_ckpt, model), cfg,
                             device=device)


def _stack(chunks: list[TestChunk], name: str) -> np.ndarray:
    """One float32 field of every chunk, stacked on the host."""
    return np.stack([np.asarray(getattr(c, name), dtype=np.float32)
                     for c in chunks])


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


def _report(errors: dict, chunk_dir: str, verbose: bool) -> None:
    if verbose:
        print(f"running data: {chunk_dir}")
        _regression_tripwire(errors)


def _summarise(all_errors: list, timing: dict, verbose: bool):
    """(all_errors, averages, timing), the averages printed."""
    averages = {}
    if all_errors:
        for k in all_errors[0]:
            averages[k] = np.mean([e[k] for e in all_errors], axis=0)
    if verbose and averages:
        print_summary(averages)
        print(f"total optimization time: {timing['total_s']:.2f}s")
    return all_errors, averages, timing


def optimize_sequence_dir(opt: SequenceOptimizer, data_dir: str,
                          verbose: bool = True, batched: bool = False):
    """Optimise every chunk directory of a sequence and average the
    metrics.  A chunk that fails to load (or, one at a time, to solve) is
    skipped and listed in timing["failed_chunks"], so one bad chunk does
    not end the sequence.  batched=True solves the sequence's chunks in
    one staged flat solve (`stage` and `optimize_chunks_batched(mode=
    'flat')`), and falls back to the per-chunk loop where their lengths
    differ.  Returns (per_chunk_errors, averages, timing).

    Over a mesh of several ranks rank 0 alone prints.  The batched solve
    takes rank 0's listing and the chunks that loaded there (a chunk
    that loads on rank 0 and fails on another raises there).  The
    per-chunk loop makes no collective call: every rank solves every
    chunk itself, so no rank waits in a collective while another
    solves."""
    verbose = verbose and opt.mesh.rank == 0
    if batched:
        res = _optimize_sequence_dir_batched(opt, data_dir, verbose)
        if res is not None:
            return res
        if verbose:
            print("batched path unavailable (unequal chunk lengths); "
                  "falling back to per-chunk")
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
        _report(errors, chunk_dir, verbose)
    return _summarise(all_errors, {
        "total_s": float(np.sum(timings)),
        "per_chunk_s": float(np.mean(timings)) if timings else 0.0,
        "failed_chunks": failures}, verbose)


def _optimize_sequence_dir_batched(opt: SequenceOptimizer, data_dir: str,
                                   verbose: bool = True):
    """One staged flat solve over a sequence directory's chunks (those
    that load on rank 0; the others are listed as failed).  None where
    their lengths differ (the caller falls back to the per-chunk loop)."""
    dirs, chunks, failures = [], [], []
    if opt.mesh.rank == 0:
        for chunk_dir in list_chunk_dirs(data_dir):
            try:
                chunks.append(load_test_chunk(chunk_dir))
                dirs.append(chunk_dir)
            except Exception as e:  # noqa: BLE001 - isolate a corrupt chunk
                failures.append((chunk_dir, repr(e)))
                if verbose:
                    print(f"SKIPPED corrupt chunk {chunk_dir}: {e!r}")
    if opt.mesh.size > 1:
        dirs, failures = broadcast_object(opt.mesh, (dirs, failures))
        if opt.mesh.rank:
            chunks = [load_test_chunk(d) for d in dirs]
    if not chunks:
        return [], {}, {"total_s": 0.0, "per_chunk_s": 0.0,
                        "failed_chunks": failures}
    if len({c.n_frames for c in chunks}) != 1:
        return None
    t0 = time.perf_counter()
    res = opt.optimize_chunks_batched(opt.stage(chunks), mode="flat")
    if res.optimized.is_cuda:
        torch.cuda.synchronize(res.optimized.device)
    total = time.perf_counter() - t0     # the solve, not the metrics
    errs = {k: _numpy(v) for k, v in calculate_errors(
        res.estimated, res.mid, res.optimized, res.gt).items()}
    all_errors = []
    for i, chunk_dir in enumerate(dirs):
        errors = {k: v[i] for k, v in errs.items()}
        all_errors.append(errors)
        _report(errors, chunk_dir, verbose)
    return _summarise(all_errors, {
        "total_s": float(total), "per_chunk_s": float(total) / len(chunks),
        "failed_chunks": failures}, verbose)


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
