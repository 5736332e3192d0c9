"""Plain PyTorch reference of the prior's first training steps.

The ConvVAE of Wang et al., ICCV 2021 (networks/SeqConvVAE.py) trained as
networks/train_global.sh trains it: five Conv1d(k=3) -> BatchNorm ->
LeakyReLU(0.01) blocks, a channel-major flatten and the fc_mu / fc_var
heads; z = mu + noise exp(log_var / 2); a dense layer back to C x T, four
ConvTranspose1d -> BatchNorm -> LeakyReLU blocks, a fifth and a Conv1d
to 45 channels.  BatchNorm normalises with the batch's mean and biased
variance (clamped at 0).  The loss is the mean squared error plus
kld_weight times the batch mean of the KL divergence; Adam with betas
(0.9, 0.999), eps 1e-8 and bias correction updates every parameter.
The noise of step s is JAX's normal draw under fold_in(PRNGKey(seed +
1), s) (`threefry.py`).  Float32 with TF32 off; `tf32=True` is the
control, the next precision down.  Written from those definitions: it
imports nothing of the program.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

from egobench.reference import threefry

BN_EPS = 1e-5
LEAK = 0.01
BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8


@contextlib.contextmanager
def tf32(on: bool):
    """TF32 for float32 matmuls and convolutions on or off inside."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def _bn(x, p, name):
    mean = x.mean(dim=(0, 2))
    var = torch.clamp((x * x).mean(dim=(0, 2)) - mean * mean, min=0.0)
    mul = torch.rsqrt(var + BN_EPS) * p[name + ".weight"]
    return (x - mean[:, None]) * mul[:, None] + p[name + ".bias"][:, None]


def loss_of(p: dict, batch, noise, prior: dict, kld_weight: float):
    """The ELBO of `batch` (B, T, 45) under parameters `p` (name ->
    tensor) with the reparameterisation `noise` (B, latent)."""
    hidden, t = list(prior["hidden_dims"]), prior["seq_len"]
    h = batch.transpose(1, 2)
    for i in range(len(hidden)):
        h = F.conv1d(h, p[f"encoder.{i}.0.weight"],
                     p[f"encoder.{i}.0.bias"], padding=1)
        h = F.leaky_relu(_bn(h, p, f"encoder.{i}.1"), LEAK)
    h = h.flatten(1)
    mu = F.linear(h, p["fc_mu.weight"], p["fc_mu.bias"])
    log_var = F.linear(h, p["fc_var.weight"], p["fc_var.bias"])
    z = mu + noise * torch.exp(0.5 * log_var)
    h = F.linear(z, p["decoder_input.weight"], p["decoder_input.bias"])
    h = h.view(-1, hidden[-1], t)
    blocks = [f"decoder.{i}" for i in range(len(hidden) - 1)] + \
        ["final_layer"]
    for name in blocks:
        h = F.conv_transpose1d(h, p[name + ".0.weight"],
                               p[name + ".0.bias"], padding=1)
        h = F.leaky_relu(_bn(h, p, name + ".1"), LEAK)
    h = F.conv1d(h, p["final_layer.3.weight"], p["final_layer.3.bias"],
                 padding=1)
    recon = torch.square(h.transpose(1, 2) - batch).mean()
    kld = torch.mean(-0.5 * torch.sum(
        1 + log_var - torch.square(mu) - torch.exp(log_var), dim=1))
    return recon + kld_weight * kld


def first_steps(state: dict, batches: list, seed: int, prior: dict,
                kld_weight: float, lr: float, device, tf32_on=False
                ) -> dict:
    """Adam steps 0..len(batches)-1 from the raw state dict `state` on
    `device`: each step's loss, the first step's gradient and the change
    of every parameter after the last step, per parameter name."""
    names = [k for k, v in state.items()
             if v.is_floating_point() and ".running_" not in k]
    p = {k: state[k].detach().to(device, torch.float32).clone()
         for k in names}
    start = {k: v.clone() for k, v in p.items()}
    m = {k: torch.zeros_like(v) for k, v in p.items()}
    v2 = {k: torch.zeros_like(v) for k, v in p.items()}
    base = threefry.key(seed + 1)
    losses, first_grad = [], None
    with tf32(tf32_on):
        for step, batch in enumerate(batches):
            x = torch.as_tensor(batch, dtype=torch.float32, device=device)
            noise = threefry.normal(threefry.fold_in(base, step),
                                    (x.shape[0], prior["latent_dim"]),
                                    device)
            leaves = {k: t.requires_grad_(True) for k, t in p.items()}
            loss = loss_of(leaves, x, noise, prior, kld_weight)
            grads = torch.autograd.grad(loss, [leaves[k] for k in names])
            losses.append(float(loss.detach()))
            g = dict(zip(names, grads))
            if first_grad is None:
                first_grad = {k: t.detach().clone() for k, t in g.items()}
            n = step + 1
            with torch.no_grad():
                for k in names:
                    m[k].mul_(BETAS[0]).add_(g[k], alpha=1 - BETAS[0])
                    v2[k].mul_(BETAS[1]).addcmul_(g[k], g[k],
                                                  value=1 - BETAS[1])
                    denom = (v2[k].sqrt() / (1 - BETAS[1] ** n) ** 0.5
                             ).add_(ADAM_EPS)
                    p[k] = p[k].detach() - (lr / (1 - BETAS[0] ** n)) \
                        * m[k] / denom
    return {"losses": losses, "grad": first_grad,
            "delta": {k: (p[k] - start[k]).detach() for k in names}}
