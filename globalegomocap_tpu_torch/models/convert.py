"""Carry JAX/Flax ConvVAE variables across to the port's state dict.

The port's own jax-free code, following the layout rules of
`globalegomocap_tpu/models/torch_convert.py`:

  1. flax conv kernel (k, in, out)      -> torch Conv1d weight (out, in, k)
  2. flax decoder kernels are convs with the time axis already flipped
     relative to a stride-1 ConvTranspose1d(k=3, p=1):
     torch ConvT weight (in, out, k) = flip_k(kernel).transpose(in, out, k)
  3. Flax flattens sequences time-major (T, C), torch channel-major
     (C, T): the Linear layers touching the flattened activations
     (fc_mu, fc_var in-columns; decoder_input out-rows) are permuted.

Variables are the Flax {'params', 'batch_stats'} tree with numpy (or
array-like) leaves; BN-folded trees (empty 'batch_stats', no 'bn'
entries) convert to state dicts for `ConvVAE(use_bn=False)`.
`params_to_flax` is the inverse, for priors the port writes as msgpack.
"""

from __future__ import annotations

import numpy as np
import torch


def _perm_ct_to_tc(n_channels: int, seq_len: int) -> np.ndarray:
    """out[i_tc] = in[perm[i_tc]]: position (t, c) -> torch index c*T+t."""
    return np.arange(n_channels * seq_len).reshape(n_channels,
                                                   seq_len).T.reshape(-1)


def params_from_flax(variables) -> dict:
    """Flax ConvVAE variables -> the port's ConvVAE state dict (float32
    tensors).  hidden_dims and seq_len are read from the kernel shapes."""
    params = variables["params"]
    stats = variables.get("batch_stats") or {}
    a = lambda x: np.asarray(x, dtype=np.float32)  # noqa: E731
    n_enc = sum(1 for k in params if k.startswith("enc_"))
    hidden = [a(params[f"enc_{i}"]["conv"]["kernel"]).shape[-1]
              for i in range(n_enc)]
    c_last = hidden[-1]
    seq_len = a(params["fc_mu"]["kernel"]).shape[0] // c_last
    inv_perm = np.argsort(_perm_ct_to_tc(c_last, seq_len))
    out: dict = {}

    def block(dst_conv, dst_bn, src, transposed):
        kernel = a(params[src]["conv"]["kernel"])          # (k, in, out)
        out[f"{dst_conv}.weight"] = (
            np.transpose(kernel, (1, 2, 0))[:, :, ::-1] if transposed
            else np.transpose(kernel, (2, 1, 0)))
        out[f"{dst_conv}.bias"] = a(params[src]["conv"]["bias"])
        if "bn" in params[src]:
            out[f"{dst_bn}.weight"] = a(params[src]["bn"]["scale"])
            out[f"{dst_bn}.bias"] = a(params[src]["bn"]["bias"])
            out[f"{dst_bn}.running_mean"] = a(stats[src]["bn"]["mean"])
            out[f"{dst_bn}.running_var"] = a(stats[src]["bn"]["var"])
            out[f"{dst_bn}.num_batches_tracked"] = np.asarray(0)

    for i in range(n_enc):
        block(f"encoder.{i}.0", f"encoder.{i}.1", f"enc_{i}", False)
    for name in ("fc_mu", "fc_var"):
        w = a(params[name]["kernel"])                      # (in_tc, out)
        out[f"{name}.weight"] = np.transpose(w[inv_perm, :])
        out[f"{name}.bias"] = a(params[name]["bias"])
    w = a(params["decoder_input"]["kernel"])               # (in, out_tc)
    out["decoder_input.weight"] = np.transpose(w[:, inv_perm])
    out["decoder_input.bias"] = a(params["decoder_input"]["bias"])[inv_perm]
    for i in range(n_enc - 1):
        block(f"decoder.{i}.0", f"decoder.{i}.1", f"dec_{i}", True)
    block("final_layer.0", "final_layer.1", "final_block", True)
    out["final_layer.3.weight"] = np.transpose(
        a(params["final_conv"]["kernel"]), (2, 1, 0))
    out["final_layer.3.bias"] = a(params["final_conv"]["bias"])
    return {k: torch.from_numpy(np.array(v)) for k, v in out.items()}


def params_to_flax(state: dict) -> dict:
    """The port's ConvVAE state dict -> Flax {'params', 'batch_stats'}
    with float32 numpy leaves: the inverse of `params_from_flax`, so that
    the port writes priors the JAX package reads
    (`models/checkpoint.py::save_msgpack`)."""
    a = lambda k: state[k].detach().to(torch.float32).cpu().numpy()  # noqa
    n_enc = len({k.split(".")[1] for k in state if k.startswith("encoder.")})
    c_last = state[f"encoder.{n_enc - 1}.0.weight"].shape[0]
    seq_len = state["fc_mu.weight"].shape[1] // c_last
    perm = _perm_ct_to_tc(c_last, seq_len)
    params: dict = {}
    stats: dict = {}

    def block(src_conv, src_bn, dst, transposed):
        w = a(f"{src_conv}.weight")
        params[dst] = {"conv": {
            "kernel": np.ascontiguousarray(
                np.transpose(w[:, :, ::-1], (2, 0, 1)) if transposed
                else np.transpose(w, (2, 1, 0))),
            "bias": a(f"{src_conv}.bias")}}
        if f"{src_bn}.weight" in state:
            params[dst]["bn"] = {"bias": a(f"{src_bn}.bias"),
                                 "scale": a(f"{src_bn}.weight")}
            stats[dst] = {"bn": {"mean": a(f"{src_bn}.running_mean"),
                                 "var": a(f"{src_bn}.running_var")}}

    for i in range(n_enc):
        block(f"encoder.{i}.0", f"encoder.{i}.1", f"enc_{i}", False)
    for name in ("fc_mu", "fc_var"):
        params[name] = {
            "kernel": np.ascontiguousarray(a(f"{name}.weight").T[perm, :]),
            "bias": a(f"{name}.bias")}
    params["decoder_input"] = {
        "kernel": np.ascontiguousarray(a("decoder_input.weight").T[:, perm]),
        "bias": a("decoder_input.bias")[perm]}
    for i in range(n_enc - 1):
        block(f"decoder.{i}.0", f"decoder.{i}.1", f"dec_{i}", True)
    block("final_layer.0", "final_layer.1", "final_block", True)
    params["final_conv"] = {
        "kernel": np.ascontiguousarray(
            np.transpose(a("final_layer.3.weight"), (2, 1, 0))),
        "bias": a("final_layer.3.bias")}
    return {"params": params, "batch_stats": stats}
