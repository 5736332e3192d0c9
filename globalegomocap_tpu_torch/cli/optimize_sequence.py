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
saved with torch.save (`cli/serve.py::load_state`).  Options of later
slices raise NotImplementedError naming the option: --circular_history
true, --save true, --profile_dir, flax msgpack checkpoints, and the
configurations that `optimize/pipeline.check_supported` names.
"""

from __future__ import annotations

import argparse
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
    """A prior's state dict, checked against `model` (`serve.load_state`:
    .pth.tar training checkpoints or bare state dicts); flax msgpack waits
    for a later slice."""
    from globalegomocap_tpu_torch.cli.serve import load_state
    if path.endswith(".msgpack"):
        raise NotImplementedError(
            f"{path}: flax msgpack checkpoints are not ported yet")
    return load_state(path, model)


def _reject_later_slices(args) -> None:
    for flag, on in (("--circular_history true", args.circular_history),
                     ("--save true", args.save),
                     ("--profile_dir", args.profile_dir is not None)):
        if on:
            raise NotImplementedError(f"{flag} is not ported yet")


def main(argv=None):
    args = build_parser().parse_args(argv)
    _reject_later_slices(args)

    from globalegomocap_tpu_torch.data.test_data import (
        list_chunk_dirs, load_test_chunk)
    from globalegomocap_tpu_torch.optimize.driver import (
        SequenceOptimizer, build_model, optimize_sequence_dir)
    from globalegomocap_tpu_torch.optimize.pipeline import check_supported

    cfg = config_from_args(args)
    check_supported(cfg)
    model = build_model(cfg)
    opt = SequenceOptimizer(model, load_variables(args.local_ckpt, model),
                            load_variables(args.global_ckpt, model), cfg,
                            device=args.device)
    errors, averages, _ = optimize_sequence_dir(opt, args.data_path)

    if args.save_pose and errors:
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
    return averages


if __name__ == "__main__":
    main()
