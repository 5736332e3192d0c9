"""Serving CLI, one-shot mode: optimise every sequence directory under
--data_root and print one JSON line per sequence.

Counterpart of `globalegomocap_tpu/cli/serve.py` with the same production
solver stack (lbfgs_fixed with fused probes and the fused energy kernels,
12 iterations / history 2 / step candidates 1.0,0.1, residual stage 2 at
3 iterations, k=8 peak crops staged on the host as bf16, k=16
estimate-centred crops and the robust tier when the crop-mass guard
trips, folded BN, conv decoder, Gaussian final smoothing in the merge)
at the JAX serve's default compute tier, bfloat16_delta (--compute_dtype
takes the JAX tiers).  With --guard_crop 0 a tripped guard falls back to
the full maps, sampled as --sampling says (pallas: the heatmap_sample
CUDA kernel).  A sequence whose chunks differ in length goes through the
per-chunk `optimize_sequence_dir`.  Each record carries the JAX serve's
keys:

  {"sequence", "chunks", "windows", "latency_ms", "windows_per_sec",
   "optimized_global_mpjpe", "original_global_mpjpe"}

A sequence that fails to load, or one of whose chunks fails to solve in
the per-chunk fallback, gets {"sequence", "error"} instead (the latter
also with "failed_chunks").

    python -m globalegomocap_tpu_torch.cli.serve --data_root incoming \\
        --local_ckpt local.pth.tar --global_ckpt global.pth.tar

Checkpoints are ConvVAE state dicts in the reference's torch layout,
saved with torch.save bare or under a 'state_dict' key, as the
reference's .pth.tar training checkpoints hold them (tensors, plain
containers and an argparse.Namespace: they load with weights_only=True).
Runs on the card unless --device cpu.  latency_ms covers host staging
(the peak crops through `native/hostcrop.c`), the solve and the device
sync, as the JAX serve's does when it stages inline.
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
import time

import numpy as np
import torch

from globalegomocap_tpu_torch.config import (
    EnergyConfig, OptimizeConfig, PriorConfig, SolverConfig)


def str2bool(x: str) -> bool:
    return str(x).lower() == "true"


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--data_root", required=True,
                   help="directory whose subdirectories are sequences")
    p.add_argument("--local_ckpt", required=True)
    p.add_argument("--global_ckpt", required=True)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--camera", default="egosyn")
    p.add_argument("--latent_dim", default=2048, type=int)
    p.add_argument("--seq_len", default=10, type=int)
    p.add_argument("--hidden_dims", default="64,64,128,256,512")
    p.add_argument("--vae", default=0.0, type=float)
    p.add_argument("--smooth", default=0.001, type=float)
    p.add_argument("--bone_length", default=0.01, type=float)
    p.add_argument("--weight_3d", default=0.01, type=float)
    p.add_argument("--reproj_weight", default=0.01, type=float)
    p.add_argument("--global_weight_3d", default=None, type=float)
    p.add_argument("--global_smooth", default=None, type=float)
    p.add_argument("--global_residual", default=True, type=str2bool)
    p.add_argument("--max_iter", default=12, type=int)
    p.add_argument("--history_size", default=2, type=int)
    p.add_argument("--step_candidates", default="1.0,0.1")
    p.add_argument("--global_max_iter", default=3, type=int)
    p.add_argument("--heatmap_crop", default=8, type=int)
    p.add_argument("--sampling", default="dense",
                   choices=["gather", "dense", "pallas"],
                   help="full-map sampling (the guard_crop 0 fallback)")
    p.add_argument("--guard_crop", default=16, type=int,
                   help="k of the estimate-centred crops of a tripped "
                        "guard; 0 = the full-map fallback")
    p.add_argument("--heatmap_crop_min_mass", default=0.90, type=float)
    p.add_argument("--heatmap_dtype", default="bfloat16",
                   choices=["float32", "bfloat16"])
    p.add_argument("--compute_dtype", default="bfloat16_delta",
                   choices=["float32", "bfloat16", "bfloat16_f32enc",
                            "bfloat16_f32head", "bfloat16_delta",
                            "bfloat16_pure"],
                   help="the solve's compute tier, as the JAX serve's "
                        "(weights stay float32): bfloat16_delta runs bf16 "
                        "decoder evals and iterates the solver state in "
                        "bf16 around the float32-exact encoder mean, with a "
                        "float32 encode and output decode")
    p.add_argument("--fold_bn", default=True, type=str2bool)
    p.add_argument("--final_smooth", default=True, type=str2bool)
    p.add_argument("--stage_on_host", default=True, type=str2bool)
    p.add_argument("--watch_interval", default=0.0, type=float,
                   help="0 = one-shot (the only mode ported so far)")
    p.add_argument("--prefetch_depth", default=0, type=int,
                   help="0 = stage inline (prefetching is not ported yet)")
    p.add_argument("--max_batches", default=0, type=int,
                   help="stop after N sequences (0 = no limit)")
    p.add_argument("--with_metrics", default=True, type=str2bool)
    p.add_argument("--save_pose", default=False, type=str2bool)
    p.add_argument("--out_dir", default="results")
    return p


def config_from_args(args) -> OptimizeConfig:
    return OptimizeConfig(
        energy=EnergyConfig(vae=args.vae, smooth=args.smooth,
                            bone_length=args.bone_length,
                            weight_3d=args.weight_3d,
                            reproj=args.reproj_weight,
                            global_weight_3d=args.global_weight_3d,
                            global_smooth=args.global_smooth,
                            global_residual=args.global_residual),
        prior=PriorConfig(latent_dim=args.latent_dim, seq_len=args.seq_len,
                          hidden_dims=tuple(
                              int(x) for x in args.hidden_dims.split(","))),
        solver=SolverConfig(method="lbfgs_fixed", max_iter=args.max_iter,
                            history_size=args.history_size,
                            step_candidates=tuple(
                                float(x) for x in
                                args.step_candidates.split(",")),
                            fused_probes=True, fused_energy=True,
                            global_max_iter=args.global_max_iter),
        sampling_impl=args.sampling, heatmap_dtype=args.heatmap_dtype,
        heatmap_crop=args.heatmap_crop, guard_crop=args.guard_crop,
        heatmap_crop_min_mass=args.heatmap_crop_min_mass,
        fold_bn=args.fold_bn, dense_decoder=True, decoder_impl="conv",
        compute_dtype=args.compute_dtype, camera=args.camera,
        final_smooth=args.final_smooth)


def load_state(path: str, model=None) -> dict:
    """A ConvVAE state dict from a torch.save file: bare, or under
    'state_dict' as in the reference's .pth.tar training checkpoints
    ({'epoch', 'args', 'state_dict', 'eval_result', 'optimizer'}).
    weights_only=True lets through tensors, plain containers and the
    checkpoint's argparse.Namespace, and refuses any other pickled object.
    With `model` (a ConvVAE), a key the model lacks, a key of the model
    the file lacks, or a value of another shape raises ValueError naming
    them."""
    with torch.serialization.safe_globals([argparse.Namespace]):
        blob = torch.load(path, map_location="cpu", weights_only=True)
    if not isinstance(blob, dict):
        raise ValueError(f"{path}: holds a {type(blob).__name__}, not a "
                         "state dict or a training checkpoint")
    state = blob.get("state_dict", blob)
    if model is not None:
        want = model.state_dict()
        missing = sorted(set(want) - set(state))
        unexpected = sorted(set(state) - set(want))
        shapes = [k for k in want if k in state and (
            not isinstance(state[k], torch.Tensor)
            or state[k].shape != want[k].shape)]
        if missing or unexpected or shapes:
            raise ValueError(
                f"{path}: not a state dict of this prior: missing "
                f"{missing}, unexpected {unexpected}, mis-shaped {shapes}")
    return state


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.watch_interval > 0:
        raise NotImplementedError(
            "--watch_interval > 0 (watch mode) is not ported yet")
    if args.prefetch_depth > 0:
        raise NotImplementedError(
            "--prefetch_depth > 0 (stage prefetching) is not ported yet")
    if not args.stage_on_host:
        raise NotImplementedError(
            "--stage_on_host false (device staging) is not ported yet")

    from globalegomocap_tpu_torch.data.test_data import (
        list_chunk_dirs, load_test_chunk)
    from globalegomocap_tpu_torch.evaluation.metrics import calculate_errors
    from globalegomocap_tpu_torch.optimize.driver import (
        SequenceOptimizer, build_model, optimize_sequence_dir)
    from globalegomocap_tpu_torch.optimize.window import num_windows

    cfg = config_from_args(args)
    model = build_model(cfg)
    opt = SequenceOptimizer(model, load_state(args.local_ckpt, model),
                            load_state(args.global_ckpt, model), cfg,
                            device=args.device)
    sync = (torch.cuda.synchronize if opt.device.type == "cuda"
            else (lambda: None))

    emitted = 0
    for name in sorted(os.listdir(args.data_root)):
        if args.max_batches and emitted >= args.max_batches:
            break
        seq_dir = os.path.join(args.data_root, name)
        if not os.path.isdir(seq_dir):
            continue
        chunk_dirs = list_chunk_dirs(seq_dir)
        if not chunk_dirs:
            continue
        try:
            chunks = [load_test_chunk(d) for d in chunk_dirs]
        except (OSError, EOFError, KeyError, ValueError,
                pickle.UnpicklingError) as e:
            print(json.dumps({"sequence": name, "error": repr(e)}),
                  flush=True)
            emitted += 1
            continue
        if len({c.n_frames for c in chunks}) != 1:
            # unequal chunk lengths: the per-chunk fallback
            t0 = time.perf_counter()
            _, avg, timing = optimize_sequence_dir(opt, seq_dir,
                                                   verbose=False)
            failed = timing["failed_chunks"]
            if failed:
                # a metric over the chunks that survived would hide them
                rec = {"sequence": name, "error": failed[0][1],
                       "failed_chunks": [d for d, _ in failed]}
            else:
                rec = {"sequence": name, "chunks": len(chunks),
                       "latency_ms": round(
                           1e3 * (time.perf_counter() - t0), 1),
                       "optimized_global_mpjpe": round(float(
                           avg["optimized_global_mpjpe"]), 5)}
            print(json.dumps(rec), flush=True)
            emitted += 1
            continue
        t0 = time.perf_counter()
        staged = opt.stage(chunks, on_host=True)
        res = opt.optimize_chunks_batched(staged, mode="flat")
        sync()
        latency = time.perf_counter() - t0
        wins = sum(num_windows(c.n_frames, cfg.window.seq_len,
                               cfg.window.stride) for c in chunks)
        rec = {"sequence": name, "chunks": len(chunks), "windows": wins,
               "latency_ms": round(1e3 * latency, 1),
               "windows_per_sec": round(wins / latency, 1)}
        if args.with_metrics:
            # one batched call over the chunk axis per sequence
            errs = calculate_errors(res.estimated, res.mid, res.optimized,
                                    res.gt)
            for key in ("optimized_global_mpjpe", "original_global_mpjpe"):
                rec[key] = round(float(errs[key].mean()), 5)
        if args.save_pose:
            out = os.path.join(args.out_dir, name)
            os.makedirs(out, exist_ok=True)
            np.save(os.path.join(out, "optimized.npy"),
                    res.optimized.cpu().numpy())
        print(json.dumps(rec), flush=True)
        emitted += 1
    return emitted


if __name__ == "__main__":
    main()
