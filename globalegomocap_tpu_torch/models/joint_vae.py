"""Joint local+global sequence VAE: two priors trained together.

Counterpart of `globalegomocap_tpu/models/joint_vae.py`, the capability
the reference's joint trainer (networks/train_local_global.py) intended:
a LOCAL motion VAE and a GLOBAL (relative-global) motion VAE tied by the
camera geometry.  The local decoder's output, lifted through the window's
camera matrices into the relative-global frame, must agree with the
global branch's reconstruction:

    total = local ELBO + global ELBO
            + consistency * mean((lift(local_recon) - global_recon)^2)

so the two priors the solve consumes (stage 1 local, stage 2 global) are
trained to be geometrically compatible.

The module holds two `ConvVAE` branches under the names `local` and
`global` (state-dict keys `local.*` and `global.*`, the Flax tree's
`params/{local,global}`); `branch_variables` and `split_branches` give
the two branches' state dicts, which `SequenceOptimizer` takes as they
are.  The reparameterisation noise is the caller's, one tensor a branch
(`train/train_joint.py` draws it).
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch
from torch import nn

from globalegomocap_tpu_torch.models.conv_vae import (
    ConvVAE, reparameterize, vae_loss)
from globalegomocap_tpu_torch.ops.transforms import relative_global_pose


class JointVAEOutput(NamedTuple):
    local_recon: torch.Tensor     # (B, T, 45)
    global_recon: torch.Tensor    # (B, T, 45)
    local_mu: torch.Tensor
    local_log_var: torch.Tensor
    global_mu: torch.Tensor
    global_log_var: torch.Tensor
    lifted_local: torch.Tensor    # (B, T, 45) local recon, rel-global frame


BRANCHES = ("local", "global")


def _rel_global(local_pose: torch.Tensor, cameras: torch.Tensor):
    """(B, T, 45) camera-frame windows -> (B, T, 45) in each window's
    first camera frame."""
    b, t = local_pose.shape[0], local_pose.shape[1]
    return relative_global_pose(local_pose.reshape(b, t, 15, 3),
                                cameras).reshape(b, t, 45)


class JointLocalGlobalVAE(nn.Module):
    """Two ConvVAE branches tied by camera geometry."""

    def __init__(self, latent_dim: int = 2048, seq_len: int = 10,
                 hidden_dims: Sequence[int] = (64, 64, 128, 256, 512),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.latent_dim = latent_dim
        self.seq_len = seq_len
        self.hidden_dims = tuple(hidden_dims)
        self.dtype = dtype
        for name in BRANCHES:         # 'global' is a keyword: add_module
            self.add_module(name, ConvVAE(latent_dim=latent_dim,
                                          seq_len=seq_len,
                                          hidden_dims=hidden_dims,
                                          dtype=dtype))

    @property
    def local_vae(self) -> ConvVAE:
        return self._modules["local"]

    @property
    def global_vae(self) -> ConvVAE:
        return self._modules["global"]

    def forward(self, local_pose: torch.Tensor, cameras: torch.Tensor,
                train: bool = False, noise=None,
                mesh=None) -> JointVAEOutput:
        """local_pose: (B, T, 45) camera-frame windows; cameras: (B, T, 4,
        4) cam->world matrices; noise: None (z = mu) or the pair (local,
        global) of standard normal (B, latent) draws.  `train` runs the
        BatchNorms of both branches on the batch statistics (the global
        batch's over `mesh`'s ranks) and moves the running ones; the lifts
        are per row and need no mesh."""
        ln, gn = (None, None) if noise is None else noise
        lmu, llv = self.local_vae.encode(local_pose, train, mesh)
        local_recon = self.local_vae.decode(reparameterize(lmu, llv, ln),
                                            train, mesh)
        gmu, glv = self.global_vae.encode(_rel_global(local_pose, cameras),
                                          train, mesh)
        global_recon = self.global_vae.decode(reparameterize(gmu, glv, gn),
                                              train, mesh)
        lifted = _rel_global(local_recon.to(torch.float32), cameras)
        return JointVAEOutput(local_recon, global_recon, lmu, llv, gmu, glv,
                              lifted)

    def branch_variables(self, state: dict | None = None) -> tuple:
        """(local state dict, global state dict) of `state` (a joint state
        dict), or of this module's own weights: the priors the optimizer
        takes."""
        return split_branches(self, self.state_dict() if state is None
                              else state)


def joint_loss(out: JointVAEOutput, local_pose: torch.Tensor,
               cameras: torch.Tensor, kld_weight: float,
               consistency_weight: float = 1.0):
    """(total, {'local_recon', 'global_recon', 'local_kld', 'global_kld',
    'consistency'}): the local ELBO, the global ELBO on the windows'
    relative-global targets, and the geometric consistency."""
    rel_global = _rel_global(local_pose, cameras)
    l_loss, l_recon, l_kld = vae_loss(out.local_recon, local_pose,
                                      out.local_mu, out.local_log_var,
                                      kld_weight)
    g_loss, g_recon, g_kld = vae_loss(out.global_recon, rel_global,
                                      out.global_mu, out.global_log_var,
                                      kld_weight)
    consistency = torch.mean(torch.square(out.lifted_local
                                          - out.global_recon))
    total = l_loss + g_loss + consistency_weight * consistency
    return total, {"local_recon": l_recon, "global_recon": g_recon,
                   "local_kld": l_kld, "global_kld": g_kld,
                   "consistency": consistency}


def split_branches(model: JointLocalGlobalVAE | None, state: dict) -> tuple:
    """A joint state dict -> (local, global) ConvVAE state dicts
    (`model` is unused: the JAX package's signature)."""
    return tuple({k[len(name) + 1:]: v for k, v in state.items()
                  if k.startswith(name + ".")} for name in BRANCHES)
