"""Evaluate every sequence directory under a dataset root in one run.

Counterpart of `globalegomocap_tpu/cli/evaluate_all.py`: the reference
runs `optimize_whole_sequence.py` once per sequence; this sweeps them all
with one optimizer and prints per-sequence and overall averages and the
total wall clock.  It takes the parity CLI's parser
(`cli/optimize_sequence.py`) with --data_root in place of --data_path,
--batched (default true: each sequence's equal-length chunks in one
staged flat solve, `optimize_sequence_dir(batched=True)`; the per-chunk
loop where lengths differ) and --device (the card unless `cpu`).

    python -m globalegomocap_tpu_torch.cli.evaluate_all --data_root data \\
        --local_ckpt local.msgpack --global_ckpt global.msgpack

Every configuration flag of the parser reaches the solve
(`optimize_sequence.config_from_args`), where the JAX CLI builds its
configuration from a subset of them; at the defaults the two agree.
--profile_dir traces the sweep; --save and --save_pose write nothing
here, as in the JAX CLI.

Its batched solves run over every visible card, as the JAX CLI's shard
over every device, with no flag (`optimize_sequence.run_on_ranks`: the
group under `torchrun`, else one NCCL rank a visible card, one rank on
the CPU).  Every rank takes rank 0's sequence listing and chunk
listing; rank 0 alone prints and traces, and `main` returns rank 0's
averages.  A sequence of unequal chunk lengths is solved chunk by chunk
on every rank, with no collective.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np

from globalegomocap_tpu_torch.cli.optimize_sequence import (
    build_parser as sequence_parser, config_from_args, load_optimizer,
    run_on_ranks, str2bool, trace_context)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                parents=[sequence_parser()],
                                conflict_handler="resolve", add_help=False,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--data_root", required=True, type=str,
                   help="directory whose subdirectories are sequences")
    p.add_argument("--data_path", required=False, default=None)
    p.add_argument("--batched", default=True, type=str2bool,
                   help="solve each sequence's equal-length chunks in one "
                        "staged flat solve (per chunk where lengths differ)")
    return p


def main(argv=None) -> dict:
    """Run the sweep; returns {sequence: its metric averages}."""
    from globalegomocap_tpu_torch.cli import evaluate_all
    return run_on_ranks(evaluate_all.evaluate_rank, build_parser().parse_args(
        argv))


def evaluate_rank(mesh, args) -> dict:
    """The sweep on this rank of `mesh`: rank 0's averages on every
    rank."""
    from globalegomocap_tpu_torch.optimize.driver import (
        optimize_sequence_dir)
    from globalegomocap_tpu_torch.parallel.mesh import broadcast_object

    lead = mesh.rank == 0
    say = print if lead else (lambda *a, **k: None)
    opt = load_optimizer(args, config_from_args(args), mesh)
    sequences = broadcast_object(mesh, sorted(
        d for d in os.listdir(args.data_root)
        if os.path.isdir(os.path.join(args.data_root, d))) if lead else None)
    t0 = time.perf_counter()
    per_seq = {}
    with trace_context(args.profile_dir if lead else None):
        for seq in sequences:
            say(f"================ sequence: {seq} ================")
            _, averages, _ = optimize_sequence_dir(
                opt, os.path.join(args.data_root, seq),
                batched=args.batched)
            per_seq[seq] = averages
    total = time.perf_counter() - t0

    if per_seq:
        say("================ overall averages ================")
        for k in next(iter(per_seq.values())):
            say(f"{k}: {np.mean([v[k] for v in per_seq.values()], axis=0)}")
    say(f"total wall-clock for {len(per_seq)} sequences: {total:.2f}s")
    return broadcast_object(mesh, per_seq)


if __name__ == "__main__":
    main()
