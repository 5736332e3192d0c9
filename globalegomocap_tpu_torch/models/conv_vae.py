"""Convolutional sequence motion-VAE, the motion prior of both stages.

Counterpart of `globalegomocap_tpu/models/conv_vae.py::ConvVAE`, built
with the reference's own torch module layout (encoder.{i}.{0,1},
fc_mu, fc_var, decoder_input, decoder.{i}.{0,1}, final_layer.{0,1,3}),
so a released reference state_dict loads unchanged and JAX variables
cross through `models/convert.py::params_from_flax`.

  encoder: 5 x [Conv1d(k=3, SAME) -> BatchNorm -> LeakyReLU(0.01)],
           channel-major flatten, Linear heads fc_mu / fc_var.
  decoder: Linear latent -> C*T, 4 x [ConvTranspose1d(k=3, s=1, p=1) ->
           BN -> LeakyReLU], a final [ConvT -> BN -> LeakyReLU] and a
           Conv1d projection to 45 channels.

Public functions keep the JAX package's channels-last layout: poses are
(B, T, 45) and decoded joints (B, T, 15, 3).  `use_bn=False` builds the
model with the BatchNorms structurally absent, to pair with
`models/fold_bn.fold_batchnorm` state dicts.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn


def _block(conv: nn.Module, channels: int, use_bn: bool) -> nn.Sequential:
    return nn.Sequential(
        conv, nn.BatchNorm1d(channels) if use_bn else nn.Identity(),
        nn.LeakyReLU(0.01))


class ConvVAE(nn.Module):
    def __init__(self, in_channels: int = 45, out_channels: int = 45,
                 latent_dim: int = 2048, seq_len: int = 10,
                 hidden_dims: Sequence[int] = (64, 64, 128, 256, 512),
                 use_bn: bool = True):
        super().__init__()
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.latent_dim = latent_dim
        self.seq_len = seq_len
        self.hidden_dims = tuple(hidden_dims)
        self.use_bn = use_bn

        enc, c = [], in_channels
        for h in self.hidden_dims:
            enc.append(_block(nn.Conv1d(c, h, 3, 1, 1), h, use_bn))
            c = h
        self.encoder = nn.Sequential(*enc)
        flat = self.hidden_dims[-1] * seq_len
        self.fc_mu = nn.Linear(flat, latent_dim)
        self.fc_var = nn.Linear(flat, latent_dim)

        rev = tuple(reversed(self.hidden_dims))
        self.decoder_input = nn.Linear(latent_dim, flat)
        self.decoder = nn.Sequential(*[
            _block(nn.ConvTranspose1d(rev[i], rev[i + 1], 3, 1, 1),
                   rev[i + 1], use_bn)
            for i in range(len(rev) - 1)])
        self.final_layer = nn.Sequential(
            nn.ConvTranspose1d(rev[-1], rev[-1], 3, 1, 1),
            nn.BatchNorm1d(rev[-1]) if use_bn else nn.Identity(),
            nn.LeakyReLU(0.01),
            nn.Conv1d(rev[-1], out_channels, 3, 1, 1))

    def encode(self, pose: torch.Tensor):
        """pose (B, T, C) -> (mu, log_var), each (B, latent)."""
        h = self.encoder(pose.transpose(1, 2))
        h = h.flatten(1)                   # channel-major (C, T) flatten
        return self.fc_mu(h), self.fc_var(h)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """z (B, latent) -> (B, T, out_channels)."""
        h = self.decoder_input(z).view(-1, self.hidden_dims[-1],
                                       self.seq_len)
        h = self.final_layer(self.decoder(h))
        return h.transpose(1, 2)

    def decode_to_bodypose(self, z: torch.Tensor) -> torch.Tensor:
        """z (B, latent) -> (B, T, 15, 3) joint sequences."""
        return self.decode(z).reshape(-1, self.seq_len, 15, 3)

    def forward(self, pose: torch.Tensor):
        """Deterministic autoencode (z = mu): (reconstruction, mu, log_var)."""
        mu, log_var = self.encode(pose)
        return self.decode(mu), mu, log_var


def init_random(model: ConvVAE, generator: torch.Generator) -> ConvVAE:
    """Fill every parameter from `generator` (uniform +-1/sqrt(fan_in),
    PyTorch's default scale) and give the BatchNorms non-trivial running
    statistics, so a seeded random prior exercises BN folding."""
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, (nn.Conv1d, nn.ConvTranspose1d, nn.Linear)):
                w = mod.weight
                fan_in = w.shape[1] * (w.shape[2] if w.dim() == 3 else 1)
                if isinstance(mod, nn.ConvTranspose1d):
                    fan_in = w.shape[0] * w.shape[2]
                bound = fan_in ** -0.5
                w.uniform_(-bound, bound, generator=generator)
                mod.bias.uniform_(-bound, bound, generator=generator)
            elif isinstance(mod, nn.BatchNorm1d):
                mod.weight.uniform_(0.8, 1.2, generator=generator)
                mod.bias.uniform_(-0.1, 0.1, generator=generator)
                mod.running_mean.uniform_(-0.1, 0.1, generator=generator)
                mod.running_var.uniform_(0.8, 1.2, generator=generator)
    return model
