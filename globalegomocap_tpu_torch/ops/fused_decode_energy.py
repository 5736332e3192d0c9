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
tap) and as much backward, so at R=2, B=192 about 7.9 GFLOP: 118 us at
67 TFLOP/s of float32 on the CUDA cores, 47.7 us as three TF32 passes at
495 TFLOP/s on the tensor cores (the kernel's 3xTF32), against about
22 MB (h0 in, dE/dh0 out, context, weights), 6.5 us at 3.35 TB/s.  The
kernel runs wgmma in 3xTF32, several rows a CTA, each weight chunk staged
once for all of them; `plan` reports its launch (rows a CTA, stages, the
L2 bytes its CTAs read).  chip_smoke.py measures the time; PERF.md
records it.
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
_VP, _CI, _CF = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {"fused_decode_stage_energy_launch": (
    [_VP, _VP, ctypes.POINTER(_CI), _CI, _VP, _VP, _CI, _VP, _VP, _VP, _VP,
     _VP, _CI, _VP, _VP, _VP, _VP, _CI, _CI, _CI, _CI, _CF, _CF, _CF, _VP],
    _CI),
    "fused_decode_energy_plan": (
        [ctypes.POINTER(_CI), _CI, _CI, ctypes.POINTER(ctypes.c_longlong),
         ctypes.POINTER(ctypes.c_longlong)], _CI)}


def _library():
    """csrc/fused_decode_energy.cu, built and loaded at first use."""
    return cuda_build.library("fused_decode_energy", _SIGNATURES)


class DecoderLayers(NamedTuple):
    """The conv chain in the JAX layout plus the kernel's packed weights
    (`pack_layers`), one float32 buffer; dims = (C0, C1, ..., Cn)."""
    layers: tuple
    packed: torch.Tensor
    dims: tuple


MAX_M_TILES = 16                  # m-tiles of one kernel pass (256 rows)


def passes(dims):
    """The kernel's passes over a chain, in order: (layer, backward,
    first m-tile, m-tiles, M, K channels).  Forward layer i maps C_i to
    C_{i+1} (M = C_{i+1}, K channels C_i); backward layer i maps C_{i+1}
    back to C_i; each split into passes of at most MAX_M_TILES m-tiles of
    16 (csrc/fused_decode_energy.cu::build_plan)."""
    n = len(dims) - 1
    out = []
    for step in range(2 * n):
        bwd = step >= n
        i = 2 * n - 1 - step if bwd else step
        m, kch = (dims[i], dims[i + 1]) if bwd else (dims[i + 1], dims[i])
        mt_all = -(-m // 16)
        for t0 in range(0, mt_all, MAX_M_TILES):
            out.append((i, bwd, t0, min(MAX_M_TILES, mt_all - t0), m, kch))
    return out


def fragment_matrix(kern, backward):
    """A (M, K) of one layer as the kernel multiplies it, K ordered
    (channel block of 8, tap, channel): forward A[co][(cb, tap, c)] =
    kern[tap][cb*8 + c][co]; backward (the input transpose)
    A[ci][(cb, tap, c)] = kern[2 - tap][ci][cb*8 + c].  M padded to 16
    and the K channels to 8 with zeros."""
    w = kern.flip(0) if backward else kern.transpose(1, 2)  # (3, M, Kch)
    _, m, kch = w.shape
    pm, pk = -(-m // 16) * 16, -(-kch // 8) * 8
    w = torch.nn.functional.pad(w, (0, pk - kch, 0, pm - m))
    return w.reshape(3, pm, pk // 8, 8).permute(1, 2, 0, 3).reshape(pm, -1)


def fragments(a):
    """A (M, K), M and K multiples of 16 and 8, in mma.m16n8k8 fragment
    order [k-step][m-tile][lane][4]: lane = 4 g + t4 holds A[16 mt + g]
    [8 ks + t4], A[16 mt + g + 8][8 ks + t4], A[16 mt + g][8 ks + t4 + 4],
    A[16 mt + g + 8][8 ks + t4 + 4]."""
    m, k = a.shape
    f = a.reshape(m // 16, 2, 8, k // 8, 2, 4)      # mt, h, g, ks, kh, t4
    return f.permute(3, 0, 2, 5, 4, 1).reshape(-1)  # ks, mt, g, t4, kh, h


def pack_layers(layers: Sequence) -> DecoderLayers:
    """Pack (kernel (3, Cin, Cout), bias (Cout)) pairs for the kernel (a
    no-op for a DecoderLayers): each pass of `passes` in fragment order,
    then each layer's bias padded to 16 channels."""
    if isinstance(layers, DecoderLayers):
        return layers
    layers = tuple((k.to(torch.float32).contiguous(),
                    b.to(torch.float32).contiguous()) for k, b in layers)
    dims = [layers[0][0].shape[1]]
    for kern, bias in layers:
        if kern.dim() != 3 or kern.shape[0] != 3 or kern.shape[1] != dims[-1]:
            raise ValueError(f"layer kernel {tuple(kern.shape)} does not "
                             f"chain from {dims[-1]} channels")
        if tuple(bias.shape) != (kern.shape[2],):
            raise ValueError(f"bias {tuple(bias.shape)} for kernel "
                             f"{tuple(kern.shape)}")
        dims.append(kern.shape[2])
    parts = []
    for i, bwd, t0, mt, _, _ in passes(dims):
        a = fragment_matrix(layers[i][0], bwd)
        parts.append(fragments(a[16 * t0:16 * (t0 + mt)]))
    for _, bias in layers:
        parts.append(torch.nn.functional.pad(bias, (0, -len(bias) % 16)))
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
            h = torch.where(h >= 0.0, h, 0.01 * h)
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

class Plan(NamedTuple):
    """Kernel 5's launch (the kernel source's `fused_decode_energy_plan`):
    rows a CTA, CTAs a cluster, CTAs, ring stages, dynamic shared memory
    bytes, the weight bytes a ring stage holds, and the weight bytes the
    CTAs read from L2."""
    rows_per_block: int
    cluster: int
    ctas: int
    stages: int
    smem: int
    stage_bytes: int
    l2_bytes: int


_PLANS: dict = {}


def plan(dims, rows: int, dev: torch.device) -> Plan:
    """The launch for a chain `dims` over `rows` (probe, window) rows on
    CUDA device `dev`.  Raises ValueError where the kernel cannot take the
    chain (a layer too wide for one block's shared memory, more than
    `_MAX_LAYERS` layers, C0 not a multiple of 8, or not 45 outputs)."""
    index = dev.index if dev.index is not None else \
        torch.cuda.current_device()
    key = (index, tuple(dims), rows)
    if key not in _PLANS:
        n = len(dims) - 1
        out = (ctypes.c_longlong * 7)()
        l2 = ctypes.c_longlong(0)
        with torch.cuda.device(index):
            err = _library().fused_decode_energy_plan(
                (_CI * (n + 1))(*dims), n, rows, out, ctypes.byref(l2))
        if err != 0:
            raise RuntimeError(f"fused_decode_stage_energy: asking the card "
                               f"for its limits failed with CUDA error {err}")
        if out[0] == 0 or n > _MAX_LAYERS:
            raise ValueError(
                f"fused_decode_stage_energy: channels {tuple(dims)} over "
                f"{rows} rows: the kernel cannot take this chain (at most "
                f"{_MAX_LAYERS} layers, C0 a multiple of 8, 45 outputs, and "
                f"one row's activations must fit a block's shared memory)")
        if out[5] != sum(passes_floats(dims)):
            raise RuntimeError("fused_decode_stage_energy: the kernel's "
                               "weight layout differs from pack_layers'")
        _PLANS[key] = Plan(out[0], out[1], out[2], out[3], out[4], out[6],
                           l2.value)
    return _PLANS[key]


def passes_floats(dims):
    """Floats of each part of the packed buffer: the passes' fragments,
    then the biases."""
    sizes = [mt * 16 * 3 * (-(-kch // 8) * 8)
             for _, _, _, mt, _, kch in passes(dims)]
    return sizes + [-(-c // 16) * 16 for c in dims[1:]]


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
    expect(dl.packed, "packed weights", tuple(dl.packed.shape), f32, dev)
    plan(dl.dims, r * b, dev)
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
