"""Build, binding and launch bookkeeping shared by the port's CUDA kernels.

Each kernel source `csrc/<name>.cu` has a plain C interface.  At first use
nvcc compiles it for sm_90a into `build/kernels/lib<name>_<hash>.so` (the
hash of the source and of every `csrc/` header it includes, so an edited
source or shared header rebuilds) and ctypes loads it.
`build_all` starts one nvcc per source at once, which is how
chip_smoke.py builds them.

The launch counters (`LAUNCHES`, one integer per kernel wrapper) and the
test-only switch `plain_versions_on_cuda` live here, so every wrapper
counts and dispatches the same way: a CUDA tensor launches the kernel (or
raises), a CPU tensor runs the plain PyTorch version.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"

# kernel launches per wrapper (chip_smoke.py resets and reads them)
LAUNCHES = {"fused_stage_energy": 0, "fused_stage_energy_noreproj": 0,
            "heatmap_sample": 0, "heatmap_sample_bwd": 0,
            "lbfgs_direction": 0, "fused_decode_stage_energy": 0,
            "threefry_draw": 0}
# nvcc/ptxas output of the builds this process ran, by source name
BUILD_LOG: dict[str, str] = {}

_plain_on_cuda = False
_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


@contextlib.contextmanager
def plain_versions_on_cuda():
    """Test-only switch: inside the block, CUDA tensors run the plain
    PyTorch versions instead of the kernels (chip_smoke.py compares whole
    runs both ways).  Never on by default."""
    global _plain_on_cuda
    prev, _plain_on_cuda = _plain_on_cuda, True
    try:
        yield
    finally:
        _plain_on_cuda = prev


def use_plain(dev: torch.device) -> bool:
    """True where a wrapper runs its plain version: CPU tensors, or CUDA
    tensors inside `plain_versions_on_cuda`."""
    return dev.type == "cpu" or _plain_on_cuda


def launched(name: str, err: int) -> None:
    """Raise if the C launcher's cudaGetLastError() code is non-zero,
    else count one launch of `name`."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")
    LAUNCHES[name] += 1


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build with "
                           "the CUDA toolkit on the machine with the card")
    return path


_INCLUDE = re.compile(r'^[ \t]*#[ \t]*include[ \t]+"([^"]+)"', re.M)


def sources_of(name: str) -> list[Path]:
    """csrc/<name>.cu and the csrc/ headers it includes, transitively."""
    found, todo = [], [CSRC / f"{name}.cu"]
    while todo:
        path = todo.pop()
        if path not in found:
            found.append(path)
            todo += [path.parent / inc
                     for inc in _INCLUDE.findall(path.read_text())]
    return found


def _target(name: str) -> Path:
    digest = hashlib.sha256()
    for path in sorted(sources_of(name)):
        digest.update(path.name.encode() + b"\0" + path.read_bytes())
    return BUILD_DIR / f"lib{name}_{digest.hexdigest()[:16]}.so"


def _start(name: str, so: Path):
    """Start nvcc on csrc/<name>.cu; returns (process, temporary output)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
    cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
           "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
           "-Xptxas", "-v", "-o", str(tmp), str(CSRC / f"{name}.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True), tmp


def _finish(name: str, so: Path, proc, tmp: Path) -> Path:
    out, _ = proc.communicate(timeout=600)
    BUILD_LOG[name] = out
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {name}.cu ({proc.returncode}):"
                           f"\n{out}")
    os.replace(tmp, so)
    return so


def build_library(name: str) -> Path:
    """Compile csrc/<name>.cu (unless its build exists) and return the
    shared library's path.  nvcc runs with -Xptxas -v; its report lands
    in BUILD_LOG[name]."""
    so = _target(name)
    if so.exists():
        return so
    return _finish(name, so, *_start(name, so))


def build_all(names) -> dict[str, Path]:
    """Build several sources with one nvcc each, all started together."""
    jobs = {}
    for name in names:
        so = _target(name)
        jobs[name] = (so, None) if so.exists() else (so, _start(name, so))
    return {name: so if job is None else _finish(name, so, *job)
            for name, (so, job) in jobs.items()}


def library(name: str, signatures: dict) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu (built at first use), with
    `signatures` {function: (argtypes, restype)} declared."""
    with _lock:
        if name not in _libs:
            lib = ctypes.CDLL(str(build_library(name)))
            for fn, (argtypes, restype) in signatures.items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = restype
            _libs[name] = lib
    return _libs[name]


def stream_of(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def expect(x: torch.Tensor, name: str, shape, dtypes, dev) -> None:
    """Argument check of a wrapper: shape, dtype, device, contiguity."""
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"{name} must be a tensor")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(x.shape)}, "
                         f"expected {tuple(shape)}")
    if x.dtype not in dtypes:
        raise TypeError(f"{name}: dtype {x.dtype}, expected one of {dtypes}")
    if x.device != dev:
        raise ValueError(f"{name} is on {x.device}, expected {dev}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
