"""The decoder conv chain and the stage-1 energy in one kernel.

Replaces the Pallas TPU kernel of `globalegomocap_tpu/ops/pallas/
fused_decode_energy.py:244` `fused_decode_stage_energy`: from the first
dense layer's output h0 (R, B, T, C0) it runs the BN-folded decoder conv
chain (k=3 SAME convs, LeakyReLU 0.01 after all but the last), rearranges
the 45 output channels (joint*3 + coord) into the energy core's
coordinate-major (3, L) pose, and returns the stage-1 energy e (R, B) and
dE/dh0, forward and backward in one call.  The first dense layer and
dz = dE/dh0 . W stay outside, as plain matrix products.

`fused_decode_stage_energy` keeps the JAX signature and layouts: `layers`
is a sequence of (kernel (3, Cin, Cout), bias (Cout)) float32 pairs in the
JAX layout (tap 0 multiplies frame t-1), or the `DecoderLayers` that
`pack_layers` / `decoder_layers` build once per stage; ctx = (wvec (1, 8),
poly (1, P)).  It is a `torch.autograd.Function` whose backward is
ct[..., None, None] * dE/dh0, the JAX custom VJP.

Dispatch: a CUDA tensor launches `csrc/fused_decode_energy.cu` (built and
bound by `ops/cuda_build.py`) or raises; a CPU tensor runs the plain
PyTorch version below (the conv chain in plain ops, the energy of
`ops/fused_energy.plain_energy_and_grad`, dE/dh0 by autograd through the
chain).

Bound on the H100 (computed from the shapes, not measured): the chain is
2*(3T-2)*sum(Cin*Cout) = 10.3 MFLOP per (probe, window) forward at the
production widths (512-256-128-64-64-64-45; the edge frames have no outer
tap) and as much backward, so at R=2, B=192 about 7.9 GFLOP, 118 us at
67 TFLOP/s of float32, against about 22 MB (h0 in, dE/dh0 out, context,
weights), 6.5 us at 3.35 TB/s: operations bound it.  chip_smoke.py
measures the time; PERF.md records it.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Sequence

import torch

from globalegomocap_tpu_torch.ops import cuda_build
from globalegomocap_tpu_torch.ops.fused_energy import (
    plain_energy_and_grad)
from globalegomocap_tpu_torch.ops.skeleton import KINEMATIC_PARENTS

T_FRAMES = 10                     # the kernel's compile-time window length
_MAX_LAYERS = 8
_SMEM_LIMIT = 232448              # bytes of shared memory a block may opt into
_VP, _CI, _CF = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {"fused_decode_stage_energy_launch": (
    [_VP, _VP, ctypes.POINTER(_CI), _CI, _VP, _VP, _CI, _VP, _VP, _VP, _VP,
     _VP, _CI, _VP, _VP, _VP, _VP, _CI, _CI, _CI, _CI, _CF, _CF, _CF, _VP],
    _CI)}


def _library():
    """csrc/fused_decode_energy.cu, built and loaded at first use."""
    return cuda_build.library("fused_decode_energy", _SIGNATURES)


class DecoderLayers(NamedTuple):
    """The conv chain in the JAX layout plus the kernel's packed weights:
    per layer the forward kernel (3, Cin, Cout), the backward kernel
    (3, Cout, Cin) with its taps reversed, and the bias, one float32
    buffer; dims = (C0, C1, ..., Cn)."""
    layers: tuple
    packed: torch.Tensor
    dims: tuple


def pack_layers(layers: Sequence) -> DecoderLayers:
    """Pack (kernel (3, Cin, Cout), bias (Cout)) pairs for the kernel (a
    no-op for a DecoderLayers)."""
    if isinstance(layers, DecoderLayers):
        return layers
    layers = tuple((k.to(torch.float32).contiguous(),
                    b.to(torch.float32).contiguous()) for k, b in layers)
    dims = [layers[0][0].shape[1]]
    parts = []
    for kern, bias in layers:
        if kern.dim() != 3 or kern.shape[0] != 3 or kern.shape[1] != dims[-1]:
            raise ValueError(f"layer kernel {tuple(kern.shape)} does not "
                             f"chain from {dims[-1]} channels")
        if tuple(bias.shape) != (kern.shape[2],):
            raise ValueError(f"bias {tuple(bias.shape)} for kernel "
                             f"{tuple(kern.shape)}")
        dims.append(kern.shape[2])
        parts += [kern.reshape(-1), kern.flip(0).transpose(1, 2).reshape(-1),
                  bias]
    return DecoderLayers(layers, torch.cat(parts).contiguous(), tuple(dims))


def decoder_layers(model):
    """The port's decoder as the kernel takes it: (first_w (T*C0, latent),
    first_b (T*C0), DecoderLayers), float32, BatchNorm folded whether or
    not the model has it (the JAX branch folds inline), the first dense
    layer's rows in the JAX (t, c) order so that F.linear gives h0 as
    (T, C0).  From the model's torch layout: ConvTranspose1d weights
    (in, out, k) are the JAX kernels with the taps flipped, the last
    Conv1d (out, in, k) is not flipped."""
    from globalegomocap_tpu_torch.models.fold_bn import fold_batchnorm
    sd = model.state_dict()
    if model.use_bn:
        sd = fold_batchnorm(sd)
    f32 = {k: v.to(torch.float32) for k, v in sd.items()
           if v.is_floating_point()}
    t, c0 = model.seq_len, model.hidden_dims[-1]
    latent = model.latent_dim
    first_w = f32["decoder_input.weight"].reshape(c0, t, latent) \
        .transpose(0, 1).reshape(t * c0, latent).contiguous()
    first_b = f32["decoder_input.bias"].reshape(c0, t).t().reshape(-1) \
        .contiguous()
    names = [f"decoder.{i}.0" for i in range(len(model.hidden_dims) - 1)]
    layers = [(f32[f"{n}.weight"].flip(-1).permute(2, 0, 1), f32[f"{n}.bias"])
              for n in names + ["final_layer.0"]]
    layers.append((f32["final_layer.3.weight"].permute(2, 1, 0),
                   f32["final_layer.3.bias"]))
    return first_w, first_b, pack_layers(layers)


# ---------------------------------------------------------------------------
# plain PyTorch version
# ---------------------------------------------------------------------------

def conv3(h, kern, bias):
    """SAME k=3 conv along T of h (N, T, Cin): out[t] = k0 h[t-1] +
    k1 h[t] + k2 h[t+1] + b."""
    hp = torch.nn.functional.pad(h, (0, 0, 1, 1))
    return hp[:, :-2] @ kern[0] + hp[:, 1:-1] @ kern[1] + hp[:, 2:] @ kern[2] \
        + bias


def plain_decode_pose(h0_rt, layers):
    """The conv chain of h0 (R, B, T, C0) -> the pose (R, B, 3, L),
    coordinate-major; differentiable in h0_rt."""
    r, b, t, c0 = h0_rt.shape
    h = h0_rt.reshape(r * b, t, c0)
    for i, (kern, bias) in enumerate(layers):
        h = conv3(h, kern, bias)
        if i < len(layers) - 1:      # the JAX mask: slope 1 where pre >= 0
            h = h * torch.where(h >= 0.0, 1.0, 0.01)
    j = h.shape[-1] // 3
    return h.reshape(r, b, t, j, 3).permute(0, 1, 4, 2, 3).reshape(
        r, b, 3, t * j).contiguous()


def plain_decode_energy_and_grad(h0_rt, layers, anchor_t, crops, ox, oy,
                                 bone, wvec, poly, t, j, k, sx, sy,
                                 crop_offset):
    """The plain version: (e (R, B), dE/dh0 (R, B, T, C0), pose, dE/dpose
    (R, B, 3, L)).  The pose-space energy and gradient are those of
    `plain_energy_and_grad` (kernel 1's plain version); dE/dh0 is the
    chain's vector-Jacobian product by autograd."""
    with torch.enable_grad():
        h0 = h0_rt.detach().requires_grad_(True)
        pose = plain_decode_pose(h0, layers)
        e, g = plain_energy_and_grad(pose.detach(), anchor_t, crops, ox, oy,
                                     bone, wvec, poly, t, j, k, sx, sy,
                                     crop_offset)
        (gh0,) = torch.autograd.grad(pose, h0, grad_outputs=g)
    return e, gh0, pose.detach(), g


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------

def _smem_bytes(dims, L):
    """Shared memory of one block (one row): the saved layer inputs, the
    pose and dE/dpose, and the energy core's scratch."""
    t = T_FRAMES
    gmax = max(dims[1:-1], default=0)
    row = max(t * dims[0], 2 * t * gmax) + t * sum(dims[1:-1]) + 2 * t * dims[-1]
    return (row + 6 * L + 5 * 32) * 4


def decode_energy_and_grad(h0_rt, layers, anchor_t, crops, ox, oy, bone,
                           wvec, poly, t, j, k, full_hw, crop_offset,
                           half_extent, with_pose: bool = False):
    """(e (R, B), dE/dh0 (R, B, T, C0)), plus the decoded pose and dE/dpose
    (R, B, 3, L) when `with_pose`: the kernel on CUDA tensors, the plain
    version on CPU tensors."""
    dl = pack_layers(layers)
    if h0_rt.dim() != 4:
        raise ValueError(f"h0_rt must be (R, B, T, C0), got "
                         f"{tuple(h0_rt.shape)}")
    r, b, tt, c0 = h0_rt.shape
    L = t * j
    if j != len(KINEMATIC_PARENTS) or tt != t or dl.dims[-1] != 3 * j:
        raise ValueError(f"h0 frames {tt}, t={t}, j={j} and the chain's "
                         f"{dl.dims[-1]} output channels must agree with "
                         f"15 joints")
    if dl.dims[0] != c0:
        raise ValueError(f"h0 has {c0} channels, the chain takes "
                         f"{dl.dims[0]}")
    if r < 1 or b < 1:
        raise ValueError("empty probe or window axis")
    dev = h0_rt.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    f32 = (torch.float32,)
    expect = cuda_build.expect
    expect(h0_rt, "h0_rt", (r, b, t, c0), f32, dev)
    expect(anchor_t, "anchor_t", (b, 3, L), f32, dev)
    expect(crops, "crops", (b, k * k, L), (torch.float32, torch.bfloat16),
           dev)
    expect(ox, "ox", (b, L), f32, dev)
    expect(oy, "oy", (b, L), f32, dev)
    expect(bone, "bone", (b, L), f32, dev)
    expect(wvec, "wvec", (1, 8), f32, dev)
    if poly.dim() != 2 or poly.shape[0] != 1:
        raise ValueError(f"poly must be (1, P), got {tuple(poly.shape)}")
    expect(poly, "poly", tuple(poly.shape), f32, dev)
    fh, fw = full_hw
    sx = (fw - 1) / (2.0 * half_extent)
    sy = (fh - 1) / (2.0 * half_extent)
    if cuda_build.use_plain(dev):
        layers_dev = [(kk.to(dev), bb.to(dev)) for kk, bb in dl.layers]
        e, gh0, pose, g = plain_decode_energy_and_grad(
            h0_rt, layers_dev, anchor_t, crops, ox, oy, bone, wvec, poly, t,
            j, k, sx, sy, crop_offset)
        return (e, gh0, pose, g) if with_pose else (e, gh0)

    if t != T_FRAMES:
        raise ValueError(f"the kernel is built for T={T_FRAMES} frames")
    n = len(dl.dims) - 1
    if n > _MAX_LAYERS:
        raise ValueError(f"{n} layers: the kernel takes at most "
                         f"{_MAX_LAYERS}")
    expect(dl.packed, "packed weights", tuple(dl.packed.shape), f32, dev)
    if _smem_bytes(dl.dims, L) > _SMEM_LIMIT:
        raise ValueError(f"channels {dl.dims}: a row does not fit one "
                         f"block's shared memory")
    e = torch.empty((r, b), dtype=torch.float32, device=dev)
    gh0 = torch.empty_like(h0_rt)
    pose = g = None
    if with_pose:
        pose = torch.empty((r, b, 3, L), dtype=torch.float32, device=dev)
        g = torch.empty_like(pose)
    dims = (ctypes.c_int * (n + 1))(*dl.dims)
    err = _library().fused_decode_stage_energy_launch(
        h0_rt.data_ptr(), dl.packed.data_ptr(), dims, n, anchor_t.data_ptr(),
        crops.data_ptr(), int(crops.dtype == torch.bfloat16), ox.data_ptr(),
        oy.data_ptr(), bone.data_ptr(), wvec.data_ptr(), poly.data_ptr(),
        poly.shape[1], e.data_ptr(), gh0.data_ptr(),
        None if pose is None else pose.data_ptr(),
        None if g is None else g.data_ptr(), r, b, L, k, sx, sy,
        float(crop_offset), cuda_build.stream_of(dev))
    cuda_build.launched("fused_decode_stage_energy", err)
    return (e, gh0, pose, g) if with_pose else (e, gh0)


class _FusedDecodeStageEnergy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h0_rt, layers, anchor_t, crops, ox, oy, bone, wvec,
                poly, t, j, k, full_hw, crop_offset, half_extent):
        e, gh0 = decode_energy_and_grad(h0_rt, layers, anchor_t, crops, ox,
                                        oy, bone, wvec, poly, t, j, k,
                                        full_hw, crop_offset, half_extent)
        ctx.save_for_backward(gh0)
        return e

    @staticmethod
    def backward(ctx, ct):
        (gh0,) = ctx.saved_tensors
        return (ct[:, :, None, None] * gh0,) + (None,) * 14


def fused_decode_stage_energy(h0_rt, layers, anchor_t, crops, ox, oy, bone,
                              ctx, t, j, k, full_hw, crop_offset,
                              half_extent):
    """Per-window stage-1 energy (R, B) from the pre-decoder activation h0
    (R, B, T, C0), differentiable in h0_rt only (the decoder weights and
    the energy context are constants of the solve)."""
    return _FusedDecodeStageEnergy.apply(
        h0_rt, pack_layers(layers), anchor_t, crops, ox, oy, bone, ctx[0],
        ctx[1], t, j, k, tuple(full_hw), crop_offset, half_extent)
