"""Optimise all chunks of a sequence directory, one chunk at a time.

Counterpart of `globalegomocap_tpu/cli/optimize_sequence.py`, the
reference-parity CLI (`optimize_whole_sequence.py`): the same flags and
defaults, plus --device (the card unless `cpu`).  It prints the
17-metric summary and the total optimisation time.

    python -m globalegomocap_tpu_torch.cli.optimize_sequence \\
        --data_path data/jian3 --local_ckpt local.pth.tar \\
        --global_ckpt global.pth.tar [--sampling pallas]

With no --solver flag it runs the reference's solver, L-BFGS with a
strong-Wolfe line search (`optimize/lbfgs.py::lbfgs_minimize`); --solver
lbfgs_fixed and adam select the JAX package's other two.  Checkpoints are
the reference's .pth.tar training checkpoints or bare ConvVAE state dicts
saved with torch.save (`cli/serve.py::load_state`), or, under any other
suffix, flax msgpack files as the JAX package's trainer writes them.
--camera takes a built-in name or a calibration JSON.  --save true
writes PLY meshes of the globally aligned sequences under
--out_dir/<chunk>/; --profile_dir writes a torch.profiler Chrome trace of
the solve there.  --init sample --init_seed s starts each stage from mu
plus JAX's own threefry normal draw times the prior's std
(`models/conv_vae.py::sample_init`), as the JAX CLI does.

It solves chunk by chunk on one rank, as the JAX CLI solves on one
device.  Under `torchrun` it runs on every rank of the group (nothing
to shard: each rank solves every chunk), and rank 0 alone prints and
writes.  serve and evaluate_all shard their batched solves over ranks
through `run_on_ranks`.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import pickle


def str2bool(x: str) -> bool:
    return str(x).lower() == "true"


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--data_path", required=True, type=str)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--camera", default="egosyn", type=str)
    p.add_argument("--vae", default=0.0, type=float)
    p.add_argument("--gmm", default=0.0, type=float)
    p.add_argument("--smooth", default=0.001, type=float)
    p.add_argument("--bone_length", default=0.01, type=float)
    p.add_argument("--weight_3d", default=0.01, type=float)
    p.add_argument("--reproj_weight", default=0.01, type=float)
    p.add_argument("--save", default=False, type=str2bool)
    p.add_argument("--save_pose", default=False, type=str2bool,
                   help="write result_pose.pkl per chunk")
    p.add_argument("--final_smooth", default=True, type=str2bool)
    p.add_argument("--final_smooth_method", default="gaussian",
                   choices=["gaussian", "one_euro"])
    p.add_argument("--fold_bn", default=False, type=str2bool)
    p.add_argument("--dense_decoder", default=False, type=str2bool)
    p.add_argument("--decoder_impl", default="",
                   choices=["", "conv", "dense", "shift"])
    p.add_argument("--decoder_dtype", default="float32",
                   choices=["float32", "bfloat16"])
    p.add_argument("--compute_dtype", default="float32",
                   choices=["float32", "bfloat16", "bfloat16_f32enc",
                            "bfloat16_f32head", "bfloat16_delta",
                            "bfloat16_pure"])
    p.add_argument("--overlap_consistency", default=0.0, type=float)
    p.add_argument("--soft_smooth", default=0.0, type=float)
    p.add_argument("--input_smooth_sigma", default=1.0, type=float)
    p.add_argument("--init", default="mu", choices=["mu", "sample"])
    p.add_argument("--init_seed", default=0, type=int)
    p.add_argument("--merge", default=True, type=str2bool)
    p.add_argument("--local_ckpt", required=True, type=str)
    p.add_argument("--global_ckpt", required=True, type=str)
    p.add_argument("--latent_dim", default=2048, type=int)
    p.add_argument("--seq_len", default=10, type=int)
    p.add_argument("--hidden_dims", default="64,64,128,256,512", type=str)
    p.add_argument("--solver", default="lbfgs",
                   choices=["lbfgs", "lbfgs_fixed", "adam"])
    p.add_argument("--max_iter", default=25, type=int)
    p.add_argument("--history_size", default=25, type=int)
    p.add_argument("--step_candidates", default="1.0,0.5,0.1,0.02",
                   type=str)
    p.add_argument("--fused_probes", default=False, type=str2bool)
    p.add_argument("--circular_history", default=False, type=str2bool)
    p.add_argument("--global_weight_3d", default=None, type=float)
    p.add_argument("--global_smooth", default=None, type=float)
    p.add_argument("--global_residual", default=False, type=str2bool)
    p.add_argument("--local_residual", default=False, type=str2bool)
    p.add_argument("--fused_energy", default=False, type=str2bool)
    p.add_argument("--global_max_iter", default=None, type=int)
    p.add_argument("--unroll", default=1, type=int,
                   help="accepted for parity; the port's solver loop is "
                        "a Python loop")
    p.add_argument("--sampling", default="gather",
                   choices=["gather", "dense", "pallas"],
                   help="full-map sampling: pallas runs the heatmap_sample "
                        "CUDA kernel")
    p.add_argument("--heatmap_dtype", default="float32",
                   choices=["float32", "bfloat16"])
    p.add_argument("--heatmap_crop", default=0, type=int,
                   help="k x k peak crops (0 = full maps)")
    p.add_argument("--heatmap_crop_min_mass", default=0.90, type=float)
    p.add_argument("--guard_crop", default=0, type=int)
    p.add_argument("--out_dir", default="out", type=str)
    p.add_argument("--profile_dir", default=None, type=str)
    return p


def config_from_args(args):
    from globalegomocap_tpu_torch.config import (
        EnergyConfig, OptimizeConfig, PriorConfig, SolverConfig)
    return OptimizeConfig(
        energy=EnergyConfig(vae=args.vae, gmm=args.gmm, smooth=args.smooth,
                            bone_length=args.bone_length,
                            weight_3d=args.weight_3d,
                            reproj=args.reproj_weight,
                            overlap_consistency=args.overlap_consistency,
                            soft_smooth=args.soft_smooth,
                            global_weight_3d=args.global_weight_3d,
                            global_smooth=args.global_smooth,
                            global_residual=args.global_residual,
                            local_residual=args.local_residual),
        prior=PriorConfig(latent_dim=args.latent_dim, seq_len=args.seq_len,
                          hidden_dims=tuple(
                              int(x) for x in args.hidden_dims.split(","))),
        solver=SolverConfig(method=args.solver, max_iter=args.max_iter,
                            history_size=args.history_size,
                            step_candidates=tuple(
                                float(x) for x in
                                args.step_candidates.split(",")),
                            fused_probes=args.fused_probes,
                            circular_history=args.circular_history,
                            fused_energy=args.fused_energy,
                            unroll=args.unroll,
                            global_max_iter=args.global_max_iter,
                            init=args.init, init_seed=args.init_seed),
        sampling_impl=args.sampling, compute_dtype=args.compute_dtype,
        heatmap_dtype=args.heatmap_dtype, heatmap_crop=args.heatmap_crop,
        heatmap_crop_min_mass=args.heatmap_crop_min_mass,
        guard_crop=args.guard_crop,
        input_smooth_sigma=args.input_smooth_sigma, fold_bn=args.fold_bn,
        dense_decoder=args.dense_decoder, decoder_impl=args.decoder_impl,
        decoder_dtype=args.decoder_dtype, camera=args.camera,
        final_smooth=args.final_smooth,
        final_smooth_method=args.final_smooth_method, merge=args.merge)


def load_variables(path: str, model) -> dict:
    """A prior's state dict, checked against `model`: a torch file
    (.pth.tar, .pth, .tar, .pt) through `serve.load_state` (the
    reference's training checkpoints or bare state dicts), any other path
    as a flax msgpack file of {'params', 'batch_stats'}
    (`models/checkpoint.py`), converted by `models/convert.py`."""
    from globalegomocap_tpu_torch.cli.serve import check_state, load_state
    from globalegomocap_tpu_torch.models.checkpoint import (
        TORCH_SUFFIXES, load_msgpack)
    if path.endswith(TORCH_SUFFIXES):
        return load_state(path, model)
    from globalegomocap_tpu_torch.models.convert import params_from_flax
    blob = load_msgpack(path)
    if not isinstance(blob, dict) or "params" not in blob:
        raise ValueError(f"{path}: not a flax variables file (no 'params')")
    state = params_from_flax({"params": blob["params"],
                              "batch_stats": blob.get("batch_stats", {})})
    return check_state(state, model, path)


def load_optimizer(args, cfg, mesh=None):
    """The SequenceOptimizer of `cfg` on the priors the arguments name,
    over `mesh` (default: `make_mesh` on --device, which takes the
    default group where one exists)."""
    from globalegomocap_tpu_torch.optimize.driver import (
        SequenceOptimizer, build_model)
    from globalegomocap_tpu_torch.optimize.pipeline import check_supported
    check_supported(cfg)
    model = build_model(cfg)
    return SequenceOptimizer(model, load_variables(args.local_ckpt, model),
                             load_variables(args.global_ckpt, model), cfg,
                             device=args.device, mesh=mesh)


def rank_mesh(device):
    """This process's mesh on `device` (resolved): under a default group
    (`torchrun`) its rank of the group, where a card named without an
    index is cuda:LOCAL_RANK under NCCL (`make_mesh`); else one rank."""
    from globalegomocap_tpu_torch.parallel.mesh import make_mesh
    card = device.type == "cuda" and device.index is None
    return make_mesh(device=None if card else device)


def run_on_ranks(fn, args):
    """`fn(mesh, args)` on the ranks a batched command runs on, as the
    JAX package shards its batched solve over every visible device:
    under `torchrun` (a default group exists) on this process's rank of
    it; with --device cuda and no group one rank a visible card
    (`cli/train.py::ranks_for` at --num_devices 0), NCCL ranks started by
    `parallel/mesh.py::spawn` where more than one card is visible, and no
    spawn and no group where one is (or where the device names its
    card); on the CPU one rank.  Returns rank 0's result (this rank's
    under torchrun).  A rank that raises makes this raise: nothing is
    retried on fewer ranks."""
    import torch.distributed as dist

    from globalegomocap_tpu_torch.cli.train import ranks_for
    from globalegomocap_tpu_torch.device import resolve_device
    from globalegomocap_tpu_torch.parallel.mesh import spawn

    device = resolve_device(args.device)
    if dist.is_available() and dist.is_initialized():
        return fn(rank_mesh(device), args)
    world = 1 if device.index is not None else ranks_for(0, device)
    if world == 1:
        return fn(rank_mesh(device), args)
    return spawn(fn, world, [f"cuda:{i}" for i in range(world)],
                 args=(args,))[0]


def trace_context(profile_dir):
    """A torch.profiler trace into `profile_dir`, or nothing."""
    if not profile_dir:
        return contextlib.nullcontext()
    from globalegomocap_tpu_torch.utils.profiling import device_trace
    return device_trace(profile_dir)


def main(argv=None):
    args = build_parser().parse_args(argv)

    from globalegomocap_tpu_torch.data.test_data import (
        list_chunk_dirs, load_test_chunk)
    from globalegomocap_tpu_torch.optimize.driver import (
        optimize_sequence_dir)

    from globalegomocap_tpu_torch.device import resolve_device
    opt = load_optimizer(args, config_from_args(args),
                         rank_mesh(resolve_device(args.device)))
    lead = opt.mesh.rank == 0
    with trace_context(args.profile_dir if lead else None):
        errors, averages, _ = optimize_sequence_dir(opt, args.data_path)

    if args.save_pose and errors and lead:
        for chunk_dir in list_chunk_dirs(args.data_path):
            _, est, mid_local, opt_seq, gt = opt.run(
                load_test_chunk(chunk_dir), with_metrics=False)
            out_dir = os.path.join(args.out_dir,
                                   os.path.basename(args.data_path),
                                   os.path.basename(chunk_dir))
            os.makedirs(out_dir, exist_ok=True)
            with open(os.path.join(out_dir, "result_pose.pkl"), "wb") as f:
                pickle.dump({"estimated_pose": est,
                             "optimized_pose": opt_seq,
                             "mid_optimized_pose": mid_local,
                             "gt_pose": gt}, f)

    if args.save and errors and lead:
        import torch
        from globalegomocap_tpu_torch.evaluation.metrics import (
            align_sequence_globally)
        from globalegomocap_tpu_torch.tools.ply import save_skeleton_sequence

        def aligned(seq, gt):
            return align_sequence_globally(
                torch.from_numpy(seq), torch.from_numpy(gt)).numpy()
        for chunk_dir in list_chunk_dirs(args.data_path):
            _, est, _, opt_seq, gt = opt.run(load_test_chunk(chunk_dir),
                                             with_metrics=False)
            base = os.path.join(args.out_dir, os.path.basename(chunk_dir))
            save_skeleton_sequence(aligned(opt_seq, gt), os.path.join(
                base, "optimized_global_aligned"))
            save_skeleton_sequence(aligned(est, gt), os.path.join(
                base, "input_global_aligned"))
            save_skeleton_sequence(gt, os.path.join(base,
                                                    "gt_global_aligned"))
    return averages


if __name__ == "__main__":
    main()
