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
     With the bone-length branch the flattened activations meet
     fusion_dense instead: its first C*T in-columns are permuted and its
     512 bone columns are not, and fc_mu / fc_var, which then read
     fusion_bn's plain feature vector, are not permuted.

Variables are the Flax {'params', 'batch_stats'} tree with numpy (or
array-like) leaves; BN-folded trees (empty 'batch_stats', no 'bn'
entries) convert to state dicts for `ConvVAE(use_bn=False)`.
`params_to_flax` is the inverse, for priors the port writes as msgpack.
A joint local+global prior (`models/joint_vae.py`) crosses branch by
branch (`joint_params_from_flax`, `joint_params_to_flax`): Flax's
`params/{local,global}/...` and `batch_stats/{local,global}/...` are
two ConvVAE trees, the port's `local.*` and `global.*` keys two ConvVAE
state dicts.

An optimizer's state crosses too (`opt_state_to_flax`,
`opt_state_from_flax`): optax's Adam moments are trees of the params'
structure, and go through the same transposes, flips and (T, C) <-> (C,
T) permutations as the parameters; those are permutations, so they
commute with Adam's elementwise update.
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
    return _from_flax(variables["params"],
                      variables.get("batch_stats") or {})


def joint_params_from_flax(variables) -> dict:
    """Flax JointLocalGlobalVAE variables -> the port's joint state dict
    (keys 'local.*' and 'global.*')."""
    stats = variables.get("batch_stats") or {}
    out = {}
    for name in ("local", "global"):
        branch = params_from_flax({"params": variables["params"][name],
                                   "batch_stats": stats.get(name, {})})
        out.update({f"{name}.{k}": v for k, v in branch.items()})
    return out


def joint_params_to_flax(state: dict) -> dict:
    """The port's joint state dict -> Flax {'params': {'local', 'global'},
    'batch_stats': {'local', 'global'}}: the inverse of
    `joint_params_from_flax`."""
    params, stats = {}, {}
    for name in ("local", "global"):
        flax = params_to_flax({k[len(name) + 1:]: v for k, v in state.items()
                               if k.startswith(name + ".")})
        params[name], stats[name] = flax["params"], flax["batch_stats"]
    return {"params": params, "batch_stats": stats}


def _from_flax(params, stats) -> dict:
    """A Flax params tree (and its batch_stats; None = the parameters
    alone, as in an optimizer's moment trees) -> torch-named tensors."""
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
        if "bn" in params[src] and stats is not None:
            out[f"{dst_bn}.running_mean"] = a(stats[src]["bn"]["mean"])
            out[f"{dst_bn}.running_var"] = a(stats[src]["bn"]["var"])
            out[f"{dst_bn}.num_batches_tracked"] = np.asarray(0)

    for i in range(n_enc):
        block(f"encoder.{i}.0", f"encoder.{i}.1", f"enc_{i}", False)
    bone = "fusion_dense" in params
    for name in ("fc_mu", "fc_var"):
        w = a(params[name]["kernel"])                      # (in_tc, out)
        out[f"{name}.weight"] = np.transpose(w if bone else w[inv_perm, :])
        out[f"{name}.bias"] = a(params[name]["bias"])
    if bone:
        ct = len(inv_perm)
        w = a(params["fusion_dense"]["kernel"])        # (in_tc + 512, out)
        out["fusion_dense.weight"] = np.transpose(
            np.concatenate([w[:ct][inv_perm], w[ct:]]))
        out["fusion_dense.bias"] = a(params["fusion_dense"]["bias"])
        out["bone_dense.weight"] = np.transpose(
            a(params["bone_dense"]["kernel"]))
        out["bone_dense.bias"] = a(params["bone_dense"]["bias"])
        for bn in ("bone_bn", "fusion_bn"):
            out[f"{bn}.weight"] = a(params[bn]["scale"])
            out[f"{bn}.bias"] = a(params[bn]["bias"])
            if stats is not None:
                out[f"{bn}.running_mean"] = a(stats[bn]["mean"])
                out[f"{bn}.running_var"] = a(stats[bn]["var"])
                out[f"{bn}.num_batches_tracked"] = np.asarray(0)
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
    # copies: a live model's or optimizer's tensors change at its next step
    a = lambda k: np.array(state[k].detach().to(torch.float32).cpu())  # noqa
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
        if f"{src_bn}.running_mean" in state:
            stats[dst] = {"bn": {"mean": a(f"{src_bn}.running_mean"),
                                 "var": a(f"{src_bn}.running_var")}}

    for i in range(n_enc):
        block(f"encoder.{i}.0", f"encoder.{i}.1", f"enc_{i}", False)
    bone = "fusion_dense.weight" in state
    for name in ("fc_mu", "fc_var"):
        w = a(f"{name}.weight").T
        params[name] = {
            "kernel": np.ascontiguousarray(w if bone else w[perm, :]),
            "bias": a(f"{name}.bias")}
    if bone:
        w = a("fusion_dense.weight").T
        params["fusion_dense"] = {
            "kernel": np.ascontiguousarray(
                np.concatenate([w[:len(perm)][perm], w[len(perm):]])),
            "bias": a("fusion_dense.bias")}
        params["bone_dense"] = {
            "kernel": np.ascontiguousarray(a("bone_dense.weight").T),
            "bias": a("bone_dense.bias")}
        for bn in ("bone_bn", "fusion_bn"):
            params[bn] = {"bias": a(f"{bn}.bias"),
                          "scale": a(f"{bn}.weight")}
            if f"{bn}.running_mean" in state:
                stats[bn] = {"mean": a(f"{bn}.running_mean"),
                             "var": a(f"{bn}.running_var")}
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


def _optax_layout(weight_decay: bool, schedule: bool) -> list:
    """The entries of optax's adam / adamw chain state after the Adam
    moments: add_decayed_weights' EmptyState ({} in flax's msgpack) with
    weight decay, then the learning rate's: a schedule's step count, or a
    constant's EmptyState."""
    return (["empty"] if weight_decay else []) + \
        ["count" if schedule else "empty"]


def opt_state_to_flax(optimizer, named_params, weight_decay: bool,
                      schedule: bool) -> dict:
    """A torch.optim Adam / AdamW's state -> the tree flax's `to_bytes`
    makes of the JAX trainer's optax state under the same TrainConfig:
    {"0": {count, mu, nu}, "1": {}, ...} with int32 0-d counts and float32
    numpy moments in the Flax layout.  `named_params` are the model's
    `named_parameters()`, in the optimizer's order; a parameter with no
    state yet (no step taken) has zero moments."""
    mu, nu, count = {}, {}, 0
    for name, p in named_params:
        st = optimizer.state.get(p)
        if st:
            count = int(st["step"])
            mu[name], nu[name] = st["exp_avg"], st["exp_avg_sq"]
        else:
            mu[name] = nu[name] = torch.zeros_like(p)
    tree = {"0": {"count": np.asarray(count, np.int32),
                  "mu": params_to_flax(mu)["params"],
                  "nu": params_to_flax(nu)["params"]}}
    for i, kind in enumerate(_optax_layout(weight_decay, schedule), 1):
        tree[str(i)] = ({"count": np.asarray(count, np.int32)}
                        if kind == "count" else {})
    return tree


def opt_state_from_flax(tree, optimizer, named_params, weight_decay: bool,
                        schedule: bool) -> None:
    """Load an optax adam / adamw state tree (as `opt_state_to_flax`
    writes it, or flax's msgpack of the JAX trainer's) into `optimizer`.
    A tree of another layout than this TrainConfig's optimizer, or whose
    moments do not match the parameters, raises ValueError."""
    layout = _optax_layout(weight_decay, schedule)
    want = {str(i) for i in range(len(layout) + 1)}
    if not isinstance(tree, dict) or set(tree) != want:
        raise ValueError(f"opt_state: entries {sorted(tree)} where this "
                         f"optimizer has {sorted(want)}")
    for i, kind in enumerate(layout, 1):
        keys = {"count"} if kind == "count" else set()
        if not isinstance(tree[str(i)], dict) or set(tree[str(i)]) != keys:
            raise ValueError(f"opt_state entry {i}: {tree[str(i)]!r} is not "
                             f"a {kind} state")
    adam = tree["0"]
    if set(adam) != {"count", "mu", "nu"}:
        raise ValueError(f"opt_state entry 0 has {sorted(adam)}, not Adam's "
                         "count, mu and nu")
    mu, nu = _from_flax(adam["mu"], None), _from_flax(adam["nu"], None)
    named = list(named_params)
    for moments in (mu, nu):
        bad = sorted(set(moments) ^ {n for n, _ in named}) + [
            n for n, p in named
            if n in moments and moments[n].shape != p.shape]
        if bad:
            raise ValueError(f"opt_state moments do not match the "
                             f"parameters: {bad}")
    step = torch.tensor(float(int(adam["count"])))
    sd = optimizer.state_dict()
    sd["state"] = {i: {"step": step.clone(), "exp_avg": mu[n],
                       "exp_avg_sq": nu[n]}
                   for i, (n, _) in enumerate(named)}
    optimizer.load_state_dict(sd)
