"""The ConvVAE decoder as a chain of matmuls: band matrices or shifted
taps.

Counterpart of `globalegomocap_tpu/models/dense_decoder.py`.  Every
decoder layer is a k=3, stride-1, SAME-padded convolution over the T
frames of a window, so it is a linear map of the flattened (T * C)
sequence:

- `make_dense_decoder` writes each layer as ONE banded (Cin*T, Cout*T)
  matrix.  The bands are built by pushing the identity basis through the
  port's own layers (`F.conv_transpose1d` for the decoder blocks and the
  final block, `F.conv1d` for the projection to 45 channels), so their
  layout is right by construction.
- `make_shift_decoder` keeps each layer's three taps: the output at
  frame t is x[t-1] @ K0 + x[t] @ K1 + x[t+1] @ K2 + b, computed as one
  (B*T, 3*Cin) x (3*Cin, Cout) product over the three shifted copies.  A
  ConvTranspose1d weight (Cin, Cout, 3) is the flipped convolution:
  K0 = W[:, :, 2], K2 = W[:, :, 0]; a Conv1d weight (Cout, Cin, 3) gives
  K0 = W[:, :, 0].T.

BatchNorm is folded first (`models/fold_bn.py`): eval-mode BN is an
affine map the bands and taps absorb.  `dtype` stores the matrices in
bf16 (`decoder_dtype="bfloat16"`) or float32; activations run in it and
the poses come back in float32, as the JAX decoders return them.  The
products are plain large matmuls (`torch.addmm`), which the JAX package
also computes outside any Pallas kernel.

Both return `decode_to_bodypose(z: (B, latent)) -> (B, T, 15, 3)`,
differentiable in z.  The weights are copied out of the model: a later
change to the model does not reach the decoder.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

from globalegomocap_tpu_torch.models.conv_vae import ConvVAE
from globalegomocap_tpu_torch.models.fold_bn import fold_batchnorm


def _folded(model: ConvVAE) -> ConvVAE:
    """`model` with its BatchNorms folded into the convolutions (itself
    when it has none), float32 weights."""
    if not model.use_bn:
        return model
    m = ConvVAE(model.in_channels, model.out_channels, model.latent_dim,
                model.seq_len, model.hidden_dims, use_bn=False)
    m.load_state_dict(fold_batchnorm(
        {k: v.to(torch.float32) for k, v in model.state_dict().items()}))
    return m.to(model.decoder_input.weight.device)


def _conv_layers(model: ConvVAE):
    """The decoder's convolutions in order: (weight, bias, transposed)
    for the decoder blocks, the final block and the projection."""
    convs = [(blk[0], True) for blk in model.decoder]
    convs.append((model.final_layer[0], True))
    convs.append((model.final_layer[3], False))
    return [(c.weight.detach().to(torch.float32),
             c.bias.detach().to(torch.float32), tr) for c, tr in convs]


def _first_layer(model: ConvVAE, time_major: bool):
    """decoder_input as (weight (latent, C0*T), bias (C0*T,)): the
    output's channel-major (C0, T) layout of the module, or (T, C0)."""
    w = model.decoder_input.weight.detach().to(torch.float32).t()
    b = model.decoder_input.bias.detach().to(torch.float32)
    if time_major:
        c0, t = model.hidden_dims[-1], model.seq_len
        w = w.reshape(-1, c0, t).transpose(1, 2).reshape(-1, t * c0)
        b = b.reshape(c0, t).t().reshape(-1)
    return w.contiguous(), b.contiguous()


def _band(weight, transposed: bool, seq_len: int) -> torch.Tensor:
    """The (Cin*T, Cout*T) matrix of one SAME k=3 layer on channel-major
    (C, T) vectors: the identity basis pushed through the layer."""
    cin = weight.shape[0] if transposed else weight.shape[1]
    basis = torch.eye(cin * seq_len, dtype=weight.dtype,
                      device=weight.device).reshape(-1, cin, seq_len)
    conv = F.conv_transpose1d if transposed else F.conv1d
    # without cuDNN, whose FFT algorithms would round the one-hot
    # products; the im2col product adds only zeros to each weight
    with torch.backends.cudnn.flags(enabled=False):
        out = conv(basis, weight, None, padding=1)     # (Cin*T, Cout, T)
    return out.reshape(cin * seq_len, -1)


def make_dense_decoder(model: ConvVAE, dtype: torch.dtype = torch.float32
                       ) -> Callable:
    """`decode_to_bodypose` as one banded matmul a layer.  The bands are
    exact (a one-hot times a weight); they are stored in `dtype`."""
    model = _folded(model)
    t, out_ch = model.seq_len, model.out_channels
    first_w, first_b = (x.to(dtype) for x in _first_layer(model, False))
    layers = []
    convs = _conv_layers(model)
    for i, (w, b, tr) in enumerate(convs):
        band = _band(w, tr, t)
        bias = b.repeat_interleave(t)                  # channel-major
        if i == len(convs) - 1:
            # the projection writes (T, 45) rows, the pose layout
            band = band.reshape(-1, out_ch, t).transpose(1, 2).reshape(
                band.shape[0], -1)
            bias = b.repeat(t)
        layers.append((band.to(dtype).contiguous(),
                       bias.to(dtype).contiguous()))

    def decode_to_bodypose(z: torch.Tensor) -> torch.Tensor:
        h = torch.addmm(first_b, z.to(dtype), first_w)
        for band, bias in layers[:-1]:
            h = F.leaky_relu(torch.addmm(bias, h, band), 0.01)
        band, bias = layers[-1]
        h = torch.addmm(bias, h, band)
        return h.to(torch.float32).reshape(-1, t, out_ch // 3, 3)

    return decode_to_bodypose


def _taps(weight, transposed: bool) -> torch.Tensor:
    """(3*Cin, Cout): the taps of x[t-1], x[t], x[t+1] stacked."""
    if transposed:                          # (Cin, Cout, 3), flipped
        taps = [weight[:, :, 2], weight[:, :, 1], weight[:, :, 0]]
    else:                                   # (Cout, Cin, 3)
        taps = [weight[:, :, 0].t(), weight[:, :, 1].t(),
                weight[:, :, 2].t()]
    return torch.cat(taps, dim=0)


def make_shift_decoder(model: ConvVAE, dtype: torch.dtype = torch.float32
                       ) -> Callable:
    """`decode_to_bodypose` as one product of the three shifted copies
    of the (B, T, Cin) activations with the stacked taps a layer: the
    layers' true weights, without the bands' T/3-fold inflation."""
    model = _folded(model)
    t, out_ch = model.seq_len, model.out_channels
    c0 = model.hidden_dims[-1]
    first_w, first_b = (x.to(dtype) for x in _first_layer(model, True))
    layers = [(_taps(w, tr).to(dtype).contiguous(), b.to(dtype))
              for w, b, tr in _conv_layers(model)]

    def conv(h, taps, bias):
        """(B, T, Cin) -> (B, T, Cout), SAME-padded k=3 stride-1."""
        hp = F.pad(h, (0, 0, 1, 1))
        x3 = torch.cat([hp[:, :-2], hp[:, 1:-1], hp[:, 2:]], dim=-1)
        out = torch.addmm(bias, x3.reshape(-1, x3.shape[-1]), taps)
        return out.reshape(h.shape[0], t, -1)

    def decode_to_bodypose(z: torch.Tensor) -> torch.Tensor:
        h = torch.addmm(first_b, z.to(dtype), first_w).reshape(-1, t, c0)
        for taps, bias in layers[:-1]:
            h = F.leaky_relu(conv(h, taps, bias), 0.01)
        h = conv(h, *layers[-1])
        return h.to(torch.float32).reshape(-1, t, out_ch // 3, 3)

    return decode_to_bodypose
