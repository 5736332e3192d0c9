"""Serving CLI: optimise sequence directories as they arrive under
--data_root and print one JSON line per sequence.

Counterpart of `globalegomocap_tpu/cli/serve.py`, at its defaults: the
streaming runtime (`optimize/streaming.py`) with up to --max_in_flight 3
solves queued on the card and --prefetch_depth 2 sequences staged ahead
on a worker thread (`StagePrefetcher`) while the card solves, the
crop-mass guard resolved once per stream and reused (guard policy
'first': at --prefetch_depth 0 once for the service's lifetime, else
once per scan pass), host staging of the peak crops through
`native/hostcrop.c` (--stage_on_host false stages on the device), and
the same production solver stack (lbfgs_fixed with fused probes and the
fused energy kernels, 12 iterations / history 2 / step candidates
1.0,0.1, residual stage 2 at 3 iterations, k=8 peak crops staged as
bf16, k=16 estimate-centred crops and the robust tier when the guard
trips, folded BN, the conv decoder, Gaussian final smoothing in the
merge) at the JAX serve's default compute tier, bfloat16_delta
(--compute_dtype takes the JAX tiers; --decoder_impl dense|shift and
--decoder_dtype take the JAX decoders).  With --guard_crop 0 a tripped
guard falls back to the full maps, sampled as --sampling says (pallas:
the heatmap_sample CUDA kernel).  A sequence whose chunks differ in
length goes through the per-chunk `optimize_sequence_dir`.  Each record
carries the JAX serve's keys:

  {"sequence", "chunks", "windows", "latency_ms", "windows_per_sec",
   "optimized_global_mpjpe", "original_global_mpjpe"}

latency_ms runs, as the JAX serve's does, from just before the sequence
is submitted to its emission: at --prefetch_depth > 0 it leaves out the
staging, which the worker did ahead; at 0 it includes it.  Emission is
in submission order, so a record may wait for in-flight solves ahead of
it.  A sequence that fails to load gets {"sequence", "error"} and does
not count towards --max_batches; in watch mode a load is retried on
--max_load_retries scans first (a sequence still being written).  A
sequence one of whose chunks fails to solve in the per-chunk fallback
gets {"sequence", "error", "failed_chunks"}.

    python -m globalegomocap_tpu_torch.cli.serve --data_root incoming \\
        --local_ckpt local.pth.tar --global_ckpt global.pth.tar \\
        [--watch_interval 2.0] [--max_batches 0]

--watch_interval 0 processes what is present and exits (one-shot);
> 0 rescans the root at that interval, finishing and emitting what is in
flight before it sleeps.  --max_batches > 0 exits after that many
sequences.  Checkpoints are ConvVAE state dicts in the reference's torch
layout, saved with torch.save bare or under a 'state_dict' key, as the
reference's .pth.tar training checkpoints hold them (tensors, plain
containers and an argparse.Namespace: they load with weights_only=True),
or flax msgpack files under any other suffix
(`cli/optimize_sequence.py::load_variables`).  As the JAX serve, it takes
every flag of the parity CLI (`cli/optimize_sequence.py`), with the
production defaults above.  Runs on the card unless --device cpu; a
failed staging or solve raises, with no fall back to the CPU or to
inline staging.

It runs over every visible card with no flag, as the JAX serve shards
its batched solve over every device (`optimize_sequence.run_on_ranks`):
under `torchrun` on the group's ranks, else one NCCL rank a visible card
(spawned where more than one is visible; one card runs as one process
with no group), one rank on the CPU.  Each rank stages and solves its
slice of a sequence's chunks and gathers the result.  Rank 0 scans the
root, loads, counts the load retries and decides; every rank takes its
decisions (`broadcast_object`) and loads the sequences to solve itself.
Rank 0 alone prints and writes --save_pose; every rank returns the same
count.  A sequence of unequal chunk lengths is solved chunk by chunk on
every rank, with no collective, so no rank waits in one meanwhile.  A
rank that fails makes the command fail.
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
import time

import numpy as np
import torch

from globalegomocap_tpu_torch.config import OptimizeConfig


def str2bool(x: str) -> bool:
    return str(x).lower() == "true"


def build_parser() -> argparse.ArgumentParser:
    """The parity CLI's parser (`cli/optimize_sequence.py`: every flag of
    the JAX serve, which takes the same parent) with --data_root, the
    streaming flags and serve's production defaults."""
    from globalegomocap_tpu_torch.cli.optimize_sequence import (
        build_parser as sequence_parser)
    p = argparse.ArgumentParser(description=__doc__,
                                parents=[sequence_parser()],
                                conflict_handler="resolve", add_help=False,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--data_root", required=True,
                   help="directory whose subdirectories are sequences")
    p.add_argument("--data_path", required=False, default=None)
    p.add_argument("--compute_dtype", default="bfloat16_delta",
                   choices=["float32", "bfloat16", "bfloat16_f32enc",
                            "bfloat16_f32head", "bfloat16_delta",
                            "bfloat16_pure"],
                   help="the solve's compute tier, as the JAX serve's "
                        "(weights stay float32): bfloat16_delta runs bf16 "
                        "decoder evals and iterates the solver state in "
                        "bf16 around the float32-exact encoder mean, with a "
                        "float32 encode and output decode")
    p.add_argument("--heatmap_dtype", default="bfloat16",
                   choices=["float32", "bfloat16"],
                   help="staged heat-crop storage dtype")
    p.add_argument("--guard_crop", default=16, type=int,
                   help="k of the estimate-centred crops of a tripped "
                        "guard; 0 = the full-map fallback")
    p.add_argument("--stage_on_host", default=True, type=str2bool,
                   help="crop the maps on the host before the transfer "
                        "(false: move the full maps and crop on the card)")
    p.add_argument("--watch_interval", default=0.0, type=float,
                   help="seconds between directory scans; 0 = one-shot")
    p.add_argument("--prefetch_depth", default=2, type=int,
                   help="stage up to this many sequences ahead on a worker "
                        "thread while the card solves (0 = stage inline)")
    p.add_argument("--max_in_flight", default=3, type=int,
                   help="solves queued on the card before a submission "
                        "waits for the oldest")
    p.add_argument("--max_load_retries", default=5, type=int,
                   help="watch mode: scans that retry a sequence whose "
                        "chunk load raises before its error record")
    p.add_argument("--max_batches", default=0, type=int,
                   help="stop after N sequences (0 = no limit)")
    p.add_argument("--with_metrics", default=True, type=str2bool)
    # the production solver stack, as the JAX serve sets it
    p.set_defaults(solver="lbfgs_fixed", fused_probes=True,
                   fused_energy=True, unroll=5, max_iter=12, history_size=2,
                   step_candidates="1.0,0.1", global_residual=True,
                   global_max_iter=3, heatmap_crop=8, sampling="dense",
                   fold_bn=True, dense_decoder=True, decoder_impl="conv",
                   out_dir="results")
    return p


def config_from_args(args) -> OptimizeConfig:
    from globalegomocap_tpu_torch.cli import optimize_sequence
    return optimize_sequence.config_from_args(args)


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
    return state if model is None else check_state(state, model, path)


def check_state(state: dict, model, path: str) -> dict:
    """`state` if it is a state dict of `model`: a key the model lacks, a
    key of the model the state lacks, or a value of another shape raises
    ValueError naming them."""
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


LOAD_ERRORS = (OSError, EOFError, KeyError, ValueError,
               pickle.UnpicklingError)


def main(argv=None) -> int:
    """Run the service; returns the number of sequences emitted (load
    errors not counted)."""
    from globalegomocap_tpu_torch.cli import serve
    from globalegomocap_tpu_torch.cli.optimize_sequence import run_on_ranks
    return run_on_ranks(serve.serve_rank, build_parser().parse_args(argv))


def serve_rank(mesh, args) -> int:
    """The service on this rank of `mesh`."""
    from globalegomocap_tpu_torch.cli.optimize_sequence import (
        load_optimizer)
    from globalegomocap_tpu_torch.data.test_data import (
        list_chunk_dirs, load_test_chunk)
    from globalegomocap_tpu_torch.evaluation.metrics import calculate_errors
    from globalegomocap_tpu_torch.optimize.driver import (
        optimize_sequence_dir)
    from globalegomocap_tpu_torch.optimize.streaming import (
        StagePrefetcher, StreamingOptimizer)
    from globalegomocap_tpu_torch.optimize.window import num_windows
    from globalegomocap_tpu_torch.parallel.mesh import broadcast_object

    lead = mesh.rank == 0
    cfg = config_from_args(args)
    opt = load_optimizer(args, cfg, mesh)
    service = StreamingOptimizer(opt, max_in_flight=args.max_in_flight,
                                 stage_on_host=args.stage_on_host)

    done: set[str] = set()
    pending: list[tuple[str, list, float]] = []  # (name, chunks, t_submit)
    emitted = 0

    def say(rec):
        if lead:
            print(json.dumps(rec), flush=True)

    def emit(name, chunks, t_submit, res):
        """One record for a completed submission (its event has fired)."""
        nonlocal emitted
        emitted += 1
        if not lead:
            return
        latency = time.perf_counter() - t_submit
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
        say(rec)

    def emit_completed():
        """Emit the submissions that have completed, in order."""
        while service._completed:
            name, chunks, t_submit = pending.pop(0)
            emit(name, chunks, t_submit, service._completed.pop(0))

    def drain_pending():
        """Finish and emit everything in flight (watch mode's idle pass:
        a finished sequence must not wait for the next arrival)."""
        for res in service.drain():
            name, chunks, t_submit = pending.pop(0)
            emit(name, chunks, t_submit, res)

    watch = args.watch_interval > 0
    fail_counts: dict[str, int] = {}
    loaded: dict[str, list] = {}          # rank 0's chunks of this pass

    def scan() -> list:
        """Rank 0's pass over the root: (name, chunk dirs, 'solve' or
        'error', the error) a sequence to act on, in order; a sequence
        whose load fails is retried on later scans in watch mode."""
        plan, taken = [], 0
        for name in sorted(d for d in os.listdir(args.data_root)
                           if os.path.isdir(os.path.join(args.data_root, d))
                           and d not in done):
            if args.max_batches and emitted + len(pending) + taken \
                    >= args.max_batches:
                break
            chunk_dirs = list_chunk_dirs(os.path.join(args.data_root, name))
            if not chunk_dirs:
                continue      # an empty directory: rescanned, no progress
            try:
                loaded[name] = [load_test_chunk(d) for d in chunk_dirs]
            except LOAD_ERRORS as e:
                fail_counts[name] = fail_counts.get(name, 0) + 1
                if watch and fail_counts[name] < args.max_load_retries:
                    continue                 # likely still being written
                plan.append((name, chunk_dirs, "error", repr(e)))
                continue
            plan.append((name, chunk_dirs, "solve", None))
            taken += 1
        return plan

    while True:
        plan = broadcast_object(mesh, scan() if lead else None)
        ready: list[tuple[str, list]] = []   # this pass's batches
        for name, chunk_dirs, kind, err in plan:
            done.add(name)
            if kind == "error":
                say({"sequence": name, "error": err})
                continue
            chunks = loaded.pop(name) if lead else [
                load_test_chunk(d) for d in chunk_dirs]
            if len({c.n_frames for c in chunks}) != 1:
                # unequal chunk lengths: the per-chunk fallback, on every
                # rank (no collective)
                t0 = time.perf_counter()
                _, avg, timing = optimize_sequence_dir(
                    opt, os.path.join(args.data_root, name), verbose=False)
                failed = timing["failed_chunks"]
                if failed:
                    # a metric over the chunks that survived would hide
                    # the failures
                    rec = {"sequence": name, "error": failed[0][1],
                           "failed_chunks": [d for d, _ in failed]}
                else:
                    rec = {"sequence": name, "chunks": len(chunks),
                           "latency_ms": round(
                               1e3 * (time.perf_counter() - t0), 1),
                           "optimized_global_mpjpe": round(float(
                               avg["optimized_global_mpjpe"]), 5)}
                say(rec)
                emitted += 1
                continue
            ready.append((name, chunks))

        # submit this pass's batches; with prefetch_depth > 0 the worker
        # stages sequence t+1 while the card solves t
        if ready:
            if args.prefetch_depth > 0:
                staged_iter = StagePrefetcher(
                    opt, (cs for _, cs in ready),
                    depth=args.prefetch_depth, on_host=args.stage_on_host)
            else:
                staged_iter = (cs for _, cs in ready)      # stage inline
            for (name, chunks), staged in zip(ready, staged_iter):
                t0 = time.perf_counter()
                service.submit_batch(staged)
                pending.append((name, chunks, t0))
                emit_completed()

        if args.max_batches and emitted + len(pending) >= args.max_batches:
            break
        if not watch:
            break
        if not plan:
            # an idle pass: finish and emit what is in flight, then sleep
            # (gating on progress also keeps a root of empty or failing
            # directories from spinning)
            drain_pending()
            time.sleep(args.watch_interval)

    drain_pending()
    return emitted


if __name__ == "__main__":
    main()
