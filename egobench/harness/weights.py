"""The ConvVAE prior's state dict drawn from a seed, in a few large calls.

The layout is the reference's torch module layout
(`networks/SeqConvVAE.py`: encoder.{i}.{0,1}, fc_mu, fc_var,
decoder_input, decoder.{i}.{0,1}, final_layer.{0,1,3}), worked out here
from a configuration's widths, so the benchmark needs nothing of the
program to make the weights that both the program and the plain
reference are handed.  The values follow PyTorch's default scale:
weights and biases uniform in +-1/sqrt(fan_in), BatchNorm scale in
[0.8, 1.2], shift and running mean in +-0.1, running variance in
[0.8, 1.2].
"""

from __future__ import annotations

import numpy as np


def convvae_layout(prior: dict) -> list:
    """[(key, shape, kind)] of a ConvVAE with BatchNorm; kind is
    ('w', fan_in), ('b', fan_in), 'bn_w', 'bn_b', 'bn_mean', 'bn_var' or
    'count' (num_batches_tracked)."""
    c_in, t = prior["in_channels"], prior["seq_len"]
    latent, hidden = prior["latent_dim"], list(prior["hidden_dims"])
    out = []

    def bn(prefix, ch):
        out.extend([(prefix + ".weight", (ch,), "bn_w"),
                    (prefix + ".bias", (ch,), "bn_b"),
                    (prefix + ".running_mean", (ch,), "bn_mean"),
                    (prefix + ".running_var", (ch,), "bn_var"),
                    (prefix + ".num_batches_tracked", (), "count")])

    def layer(prefix, shape, fan_in, bias_len):
        out.append((prefix + ".weight", tuple(shape), ("w", fan_in)))
        out.append((prefix + ".bias", (bias_len,), ("b", fan_in)))

    c = c_in
    for i, h in enumerate(hidden):
        layer(f"encoder.{i}.0", (h, c, 3), c * 3, h)
        bn(f"encoder.{i}.1", h)
        c = h
    flat = hidden[-1] * t
    layer("fc_mu", (latent, flat), flat, latent)
    layer("fc_var", (latent, flat), flat, latent)
    layer("decoder_input", (flat, latent), latent, flat)
    rev = hidden[::-1]
    for i in range(len(rev) - 1):
        # ConvTranspose1d weights are (in, out, k); fan_in is in * k
        layer(f"decoder.{i}.0", (rev[i], rev[i + 1], 3), rev[i] * 3,
              rev[i + 1])
        bn(f"decoder.{i}.1", rev[i + 1])
    layer("final_layer.0", (rev[-1], rev[-1], 3), rev[-1] * 3, rev[-1])
    bn("final_layer.1", rev[-1])
    layer("final_layer.3", (c_in, rev[-1], 3), rev[-1] * 3, c_in)
    return out


def draw_state(torch, prior: dict, seed: int, device) -> dict:
    """A state dict of float32 tensors on `device` from `seed`: one
    uniform draw of every float element on the device's own generator,
    then sliced and scaled per key."""
    layout = convvae_layout(prior)
    sizes = [int(np.prod(shape)) for _, shape, kind in layout
             if kind != "count"]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    u = torch.rand(sum(sizes), generator=gen, device=device) * 2.0 - 1.0
    state, at = {}, 0
    for key, shape, kind in layout:
        if kind == "count":
            state[key] = torch.zeros((), dtype=torch.int64, device=device)
            continue
        n = int(np.prod(shape))
        v = u[at:at + n].reshape(shape)
        at += n
        if isinstance(kind, tuple):
            v = v * float(kind[1]) ** -0.5
        elif kind in ("bn_w", "bn_var"):
            v = 1.0 + 0.2 * v
        else:
            v = 0.1 * v
        state[key] = v
    return state


def prior_seeds(seed: int) -> tuple:
    """The generator seeds of the local and the global prior of a run."""
    s = np.random.SeedSequence([int(seed), 0x5EED]).generate_state(2, np.uint64)
    return int(s[0]), int(s[1])
