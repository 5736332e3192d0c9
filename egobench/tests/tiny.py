"""The benchmark's cells cut to a size a CPU test holds: the prior at
latent 256 and widths (16, 16, 32, 64, 128) (at narrower
widths the random prior's solve hardly moves, and a fault that stops it
would pass unseen), requests of two 26-frame
chunks, train batches of 16 windows."""

from __future__ import annotations

import copy
import time

from egobench.harness import common

TINY_PRIOR = {"in_channels": 45, "latent_dim": 256, "seq_len": 10,
              "hidden_dims": [16, 16, 32, 64, 128]}



def cell(workload: str) -> tuple:
    """(cell, cfg, mix, limits) of `workload` at the tiny size."""
    c, cfg, mix = common.cell_files(common.benchmark(), workload)
    cfg, mix = copy.deepcopy(cfg), copy.deepcopy(mix)
    if mix["kind"] == "solve_closed_loop":
        cfg["optimize"]["prior"] = dict(TINY_PRIOR)
        mix.update(chunks_per_request=2, frames_per_chunk=26,
                   warmup_requests=1, check_from=2, check_requests=1,
                   render_threads=1)
        for g in mix["pool"]:           # a pool of two chunks
            g["count"] = 2 // len(mix["pool"])
    else:
        cfg["prior"] = dict(TINY_PRIOR)
        cfg["train"]["latent_dim"] = TINY_PRIOR["latent_dim"]
        mix.update(batch=16, corpus=dict(mix["corpus"], sequences=3,
                                         frames_per_seq=40))
    return c, cfg, mix, common.limits(workload)


def context(torch, workload: str, seed: int, device="cpu", seconds=1.0,
            program=None):
    """The tiny cell's loop and a context for it."""
    c, cfg, mix, limits = cell(workload)
    return common.loop(mix["kind"]), common.context(
        c, cfg, mix, limits, seed, seconds, torch.device(device),
        time.perf_counter(), program=program)


def run(torch, workload: str, seed: int, device="cpu", seconds=1.0,
        program=None):
    """One run of the tiny cell's loop: (run record, parts, checks)."""
    loop, ctx = context(torch, workload, seed, device, seconds, program)
    return loop.run(torch, ctx)
