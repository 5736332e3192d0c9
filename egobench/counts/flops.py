"""Operations and bytes the benchmark's shares are measured against,
counted from shapes, frozen with the benchmark.

Copies of `chip_smoke.py`'s counts as of the benchmark's first version:
the H100 peaks (`chip_smoke.py:336-340`), the train step's conv and
dense products (`step_bound`, :3113: forward, and twice that backward),
and the stage energies' operations a point (`OPS_PER_POINT_*`, :345-352,
counted from csrc/fused_energy.cu).  The solve's count is the model's:
per window, the encodes, each objective evaluation's decode and input
gradient, and the output decodes, at the configured fixed schedule,
whatever implements them.
"""

from __future__ import annotations

import json
import os

with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "peaks.json")) as _f:
    PEAKS = json.load(_f)

# float32 operations a point of the stage energies (chip_smoke.py:345-352)
OPS_PER_POINT_REPROJ = 120
OPS_PER_POINT_TAPS = 100
OPS_PER_POINT_POSE = 60
J = 15


def _conv(c_in, c_out, t):
    return 2 * c_in * c_out * 3 * t


def encoder_flops(prior: dict) -> int:
    """One window's encode: the conv stack and both heads."""
    t, c = prior["seq_len"], prior["in_channels"]
    out = 0
    for h in prior["hidden_dims"]:
        out += _conv(c, h, t)
        c = h
    flat = prior["hidden_dims"][-1] * t
    return out + 2 * 2 * flat * prior["latent_dim"]


def decoder_flops(prior: dict) -> int:
    """One window's decode: the dense layer, the transposed convs and the
    projection to 45 channels."""
    t, hid = prior["seq_len"], list(prior["hidden_dims"])[::-1]
    out = 2 * prior["latent_dim"] * hid[0] * t
    for a, b in zip(hid, hid[1:]):
        out += _conv(a, b, t)
    return out + _conv(hid[-1], hid[-1], t) + _conv(hid[-1],
                                                    prior["in_channels"], t)


def solve_flops_per_window(prior: dict, stage1: dict, stage2: dict) -> int:
    """Model operations one window of the two-stage solve needs: each
    stage's encode; at each objective evaluation of a lane (the initial
    one and `candidates` a fixed iteration) a decode and its input
    gradient (the same products again); the stage-1 output decode, the
    stage-2 residual anchor's decode and its output decode."""
    evals = sum(1 + s["iters"] * len(s["candidates"])
                for s in (stage1, stage2))
    dec = decoder_flops(prior)
    return 2 * encoder_flops(prior) + evals * 2 * dec + 3 * dec


def train_step_flops(prior: dict, batch: int) -> int:
    """A train step's products: forward (conv stack, heads, decoder) and
    twice that backward, over the batch (chip_smoke.py `step_bound`)."""
    return 3 * batch * (encoder_flops(prior) + decoder_flops(prior))


def energy_least_seconds(r: int, b: int, t: int, k: int, crop_bytes: int,
                         reproj: bool) -> float:
    """The least time of one stage-energy launch over R probe rows of B
    windows of L = t * 15 points: the pose in and the gradient and value
    out, the window context read once (anchor, bone and, with the
    reprojection, the two crop origins), and with it the four crop taps
    a point uses; against the operations a point over the float32 peak.
    The larger of the two, in seconds."""
    n = t * J
    nbytes = r * b * (3 * n * 4 * 2 + 4)
    if reproj:
        nbytes += b * 6 * n * 4 + b * n * 4 * crop_bytes
        ops = r * b * n * (OPS_PER_POINT_REPROJ + OPS_PER_POINT_TAPS)
    else:
        nbytes += b * 4 * n * 4
        ops = r * b * n * OPS_PER_POINT_POSE
    return max(nbytes / PEAKS["hbm_bytes_per_s"],
               ops / PEAKS["f32_flop_per_s"])


def energy_mean_least_seconds(windows: int, t: int, k: int, crop_bytes: int,
                              stage: dict, reproj: bool) -> float:
    """The mean least time a launch over one stage of a request: one
    launch of one probe row (the initial evaluation), then one of
    `candidates` rows an iteration."""
    kk = len(stage["candidates"])
    one = energy_least_seconds(1, windows, t, k, crop_bytes, reproj)
    many = energy_least_seconds(kk, windows, t, k, crop_bytes, reproj)
    return (one + stage["iters"] * many) / (1 + stage["iters"])
