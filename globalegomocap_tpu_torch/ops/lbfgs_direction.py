"""The L-BFGS two-loop recursion, one thread-block cluster per lane.

Replaces the Pallas TPU kernels of `globalegomocap_tpu/ops/pallas/
lbfgs_direction.py`: `lbfgs_direction_pallas` and, under `vmap`, the
lane-blocked `lbfgs_direction_pallas_batched`.  grad (B, d), s/y
histories (B, m, d) ordered oldest..newest, rho (B, m), all four float32
or all four bfloat16 (the state's dtype, as in the JAX kernel), valid
(B, m) bool -> the direction -H g (B, d) in that dtype, with the slot
masking and the initial scaling gamma = s.y / y.y of the newest valid
pair.

`two_loop_direction` is the plain PyTorch version (the JAX package's
`optimize/lbfgs.py::_two_loop_direction`, which its fixed solvers run when
the kernel is off).  `lbfgs_direction` dispatches: a CUDA tensor launches
`csrc/lbfgs_direction.cu` (built and bound by `ops/cuda_build.py`) or
raises; a CPU tensor runs the plain version.  On the card each lane is a
cluster of C CTAs, each holding a slice of d/C elements of g, s and y in
shared memory; `plan` (the kernel source's `lbfgs_direction_plan`) picks
C and the CTA's threads from m, d and the element size, and a cluster
the card cannot schedule raises.  A d whose slices are not whole 16-byte
rows is zero-padded (`pad_width`, `pad_last`) and the direction sliced
back: exact, since zero elements add nothing to any dot product and stay
zero under every update.  The m slots of s and y must fit the card's
shared memory: on an H100, m <= 221 at d = 2048 in float32 (434 in
bf16); a larger m raises ValueError on the card.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from globalegomocap_tpu_torch.ops import cuda_build

_VP, _CI = ctypes.c_void_p, ctypes.c_int
_PI = ctypes.POINTER(_CI)
_SIGNATURES = {
    "lbfgs_direction_launch": (
        [_CI, _VP, _VP, _VP, _VP, _VP, _VP, _CI, _CI, _CI, _CI, _CI, _VP],
        _CI),
    "lbfgs_direction_max_clusters": ([_CI, _CI, _CI, _CI, _CI, _PI], _CI),
    "lbfgs_direction_plan": ([_CI, _CI, _CI, _PI, _PI, _PI], _CI)}
_DTYPES = (torch.float32, torch.bfloat16)
# (device index, element bytes, m, d) -> Plan; configurations the card was
# asked about and can schedule
_PLANS: dict = {}
_SCHEDULABLE: set = set()


def _library():
    return cuda_build.library("lbfgs_direction", _SIGNATURES)


class Plan(NamedTuple):
    """One lane's launch: `cluster` CTAs of `threads` threads and `smem`
    bytes of dynamic shared memory each."""
    cluster: int
    threads: int
    smem: int


def plan(b: int, m: int, d: int, dtype: torch.dtype,
         dev: torch.device) -> Plan:
    """The launch on CUDA device `dev` for B lanes of m slots and d
    elements of `dtype`.  Raises ValueError, naming the shape, where no
    cluster of up to 16 CTAs holds its slice."""
    index = dev.index if dev.index is not None else \
        torch.cuda.current_device()
    elem = torch.empty((), dtype=dtype).element_size()
    key = (index, elem, m, d)
    if key not in _PLANS:
        out = [_CI(0) for _ in range(3)]
        with torch.cuda.device(index):
            err = _library().lbfgs_direction_plan(
                elem, m, d, *(ctypes.byref(v) for v in out))
        if err != 0:
            raise RuntimeError(f"lbfgs_direction: reading the card's shared "
                               f"memory limit failed with CUDA error {err}")
        _PLANS[key] = Plan(*(v.value for v in out)) if out[0].value else None
    if _PLANS[key] is None:
        raise ValueError(
            f"lbfgs_direction: B={b}, m={m}, d={d}, {elem}-byte "
            f"elements: no cluster of up to 16 CTAs holds its slice of "
            f"g, s and y in the card's shared memory (d * element size "
            f"must be a multiple of 16)")
    return _PLANS[key]


def pad_width(d: int, elem: int, granule: int = 1) -> int:
    """d rounded up to a whole number of `granule` 16-byte rows of
    `elem`-byte elements."""
    step = granule * 16 // elem
    return -(-d // step) * step


def pad_last(xs, width: int):
    """Each tensor zero-padded along its last axis to `width`."""
    return tuple(torch.nn.functional.pad(x, (0, width - x.shape[-1]))
                 for x in xs)


def padded_plan(b: int, m: int, d: int, dtype: torch.dtype,
                dev: torch.device) -> tuple[int, Plan]:
    """(width, plan): the narrowest zero-padded width whose slices `plan`
    takes, d rounded up to 1, 2, ..., 16 rows of 16 bytes per cluster
    CTA in turn (d itself where it fits).  Raises `plan`'s ValueError,
    naming d, where none fits."""
    elem = torch.empty((), dtype=dtype).element_size()
    for granule in (1, 2, 4, 8, 16):
        width = pad_width(d, elem, granule)
        try:
            return width, plan(b, m, width, dtype, dev)
        except ValueError:
            pass
    return d, plan(b, m, d, dtype, dev)


def _check_schedulable(bf16: int, b: int, m: int, d: int, p: Plan) -> None:
    """Ask the card (cudaOccupancyMaxActiveClusters) once per
    configuration whether it can hold one such cluster; raise if not."""
    key = (bf16, m, d, p)
    if key in _SCHEDULABLE:
        return
    count = _CI(0)
    err = _library().lbfgs_direction_max_clusters(
        bf16, m, d, p.cluster, p.threads, ctypes.byref(count))
    if err != 0 or count.value < 1:
        raise RuntimeError(
            f"lbfgs_direction: the card cannot schedule a cluster of "
            f"{p.cluster} CTAs ({p.threads} threads each) for B={b}, m={m}, "
            f"d={d}: cudaOccupancyMaxActiveClusters gave {count.value} "
            f"clusters (CUDA error {err})")
    _SCHEDULABLE.add(key)


def _dot(a, b):
    """Row-wise dot product in float32, rounded once to the inputs' dtype:
    `jnp.dot`'s bf16 semantics (exact products, a float32 sum)."""
    return (a.to(torch.float32) * b.to(torch.float32)).sum(-1).to(a.dtype)


def two_loop_direction(grad, s_hist, y_hist, rho_hist, valid):
    """Batched two-loop recursion: grad (B, d), s/y (B, m, d) ordered
    oldest..newest, rho/valid (B, m), float32 or bf16 (the state's dtype
    throughout).  Returns the direction -H g."""
    m = s_hist.shape[1]
    q = grad
    alphas = [None] * m
    for i in range(m):
        idx = m - 1 - i                                  # newest first
        a = rho_hist[:, idx] * _dot(s_hist[:, idx], q)
        a = torch.where(valid[:, idx], a, torch.zeros_like(a))
        q = q - a[:, None] * y_hist[:, idx]
        alphas[idx] = a
    # initial Hessian scaling gamma = s.y / y.y of the newest pair
    sy = (s_hist[:, m - 1] * y_hist[:, m - 1]).sum(-1)
    yy = (y_hist[:, m - 1] * y_hist[:, m - 1]).sum(-1)
    gamma = torch.where(valid[:, m - 1] & (yy > 0), sy / yy,
                        torch.ones_like(sy))
    r = gamma[:, None] * q
    for i in range(m):
        b = rho_hist[:, i] * _dot(y_hist[:, i], r)
        upd = s_hist[:, i] * (alphas[i] - b)[:, None]
        r = r + torch.where(valid[:, i, None], upd, torch.zeros_like(upd))
    return -r


def lbfgs_direction(grad, s_hist, y_hist, rho_hist, valid):
    """The two-loop direction (B, d) in the inputs' dtype: the kernel on
    CUDA tensors, the plain version on CPU tensors."""
    if grad.dim() != 2 or s_hist.dim() != 3:
        raise ValueError(f"grad must be (B, d) and s_hist (B, m, d), got "
                         f"{tuple(grad.shape)} and {tuple(s_hist.shape)}")
    b, m, d = s_hist.shape
    dev = grad.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    if b < 1 or m < 1 or d < 1:
        raise ValueError("empty lane, history or parameter axis")
    cuda_build.expect(grad, "grad", (b, d), _DTYPES, dev)
    same = (grad.dtype,)
    cuda_build.expect(s_hist, "s_hist", (b, m, d), same, dev)
    cuda_build.expect(y_hist, "y_hist", (b, m, d), same, dev)
    cuda_build.expect(rho_hist, "rho_hist", (b, m), same, dev)
    cuda_build.expect(valid, "valid", (b, m), (torch.bool,), dev)
    if cuda_build.use_plain(dev):
        return two_loop_direction(grad, s_hist, y_hist, rho_hist, valid)
    bf16 = int(grad.dtype == torch.bfloat16)
    width, p = padded_plan(b, m, d, grad.dtype, dev)
    if width != d:
        grad, s_hist, y_hist = pad_last((grad, s_hist, y_hist), width)
    _check_schedulable(bf16, b, m, width, p)
    out = torch.empty_like(grad)
    err = _library().lbfgs_direction_launch(
        bf16, grad.data_ptr(), s_hist.data_ptr(), y_hist.data_ptr(),
        rho_hist.data_ptr(), valid.data_ptr(), out.data_ptr(), b, m, width,
        p.cluster, p.threads, cuda_build.stream_of(dev))
    cuda_build.launched("lbfgs_direction", err)
    return out if width == d else out[:, :d].contiguous()
