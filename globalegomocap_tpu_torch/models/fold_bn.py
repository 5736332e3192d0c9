"""Fold eval-mode BatchNorm into the preceding convolution weights.

Counterpart of `globalegomocap_tpu/models/fold_bn.py`.  With frozen
running statistics each BN is a per-channel affine map:

    y = gamma * (W x + b - mu) / sqrt(var + eps) + beta
      = (gamma/sqrt(var+eps)) W x + (gamma (b - mu)/sqrt(var+eps) + beta)

The folded state dict drops the BN entries and pairs with
`ConvVAE(use_bn=False)` (same names, BN modules structurally absent).
"""

from __future__ import annotations

import torch

_EPS = 1e-5


def fold_batchnorm(state_dict: dict) -> dict:
    """Fold every conv block's BN of a ConvVAE state dict.  ConvTranspose1d
    weights are (in, out, k) and Conv1d weights (out, in, k); the block's
    kind is read from its name (decoder.* and final_layer.0 are
    transposed).  Exact for eval-mode inference only."""
    sd = dict(state_dict)
    out = {}
    bn_prefixes = {k[:-len(".running_var")] for k in sd
                   if k.endswith(".running_var")}
    for bn in sorted(bn_prefixes):
        head, idx = bn.rsplit(".", 1)
        conv = f"{head}.{int(idx) - 1}"
        gamma, beta = sd[f"{bn}.weight"], sd[f"{bn}.bias"]
        inv = gamma / torch.sqrt(sd[f"{bn}.running_var"] + _EPS)
        w = sd[f"{conv}.weight"]
        transposed = conv.startswith("decoder.") or conv == "final_layer.0"
        out[f"{conv}.weight"] = (w * inv[None, :, None] if transposed
                                 else w * inv[:, None, None])
        out[f"{conv}.bias"] = (sd[f"{conv}.bias"]
                               - sd[f"{bn}.running_mean"]) * inv + beta
    for k, v in sd.items():
        if k in out or any(k.startswith(bn + ".") for bn in bn_prefixes):
            continue
        out[k] = v
    return out
