"""ctypes binding of the native host peak-crop kernel (`hostcrop.c`).

The port's copy of `globalegomocap_tpu/native/hostcrop.{c,py}`.  At first
use the system C compiler (`cc -O3 -march=native`, else plain `-O3`; no
dependency beyond libc) builds the source into
`build/native/libhostcrop_<hash>.so` (the hash of the source, so an
edited source rebuilds) and ctypes loads it.

Unlike the JAX binding there is no fallback: a failed build raises
RuntimeError, and an input outside the kernel's envelope (not a 4-D
(F, H, W, J) stack, J > 64, k < 1) raises ValueError.  The numpy crop
(`energy/terms.py::crop_heatmaps_channels_last_np`) is the kernel's plain
version in the tests: crops and origins equal bit for bit; the guard's
mass sums differ only in the order of the float32 additions.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().with_name("hostcrop.c")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
# the C compiler's command; a test replaces it to show a failed build
CC = ("cc",)
MAX_J = 64            # the kernel's stack buffers (hostcrop.c MAX_J)

_lib = None
_lock = threading.Lock()


def build() -> Path:
    """Compile hostcrop.c unless its build exists; return the library's
    path.  Raises RuntimeError with the compiler's output on failure."""
    digest = hashlib.sha256(SRC.read_bytes()).hexdigest()[:16]
    so = BUILD_DIR / f"libhostcrop_{digest}.so"
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
    logs = []
    # -march=native vectorises the J-contiguous scan; plain -O3 where the
    # compiler refuses the flag
    for flags in (["-O3", "-march=native"], ["-O3"]):
        cmd = [*CC, *flags, "-shared", "-fPIC", "-o", str(tmp), str(SRC)]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  timeout=120)
        except (OSError, subprocess.TimeoutExpired) as e:
            raise RuntimeError(f"building hostcrop.c: {' '.join(cmd)}: "
                               f"{e!r}") from e
        if proc.returncode == 0:
            os.replace(tmp, so)       # atomic against concurrent builds
            return so
        logs.append(f"{' '.join(cmd)} -> {proc.returncode}\n"
                    f"{proc.stdout}{proc.stderr}")
    raise RuntimeError("building hostcrop.c failed:\n" + "\n".join(logs))


def _library() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            i64, fp = ctypes.c_int64, ctypes.POINTER(ctypes.c_float)
            lib.crop_peak_f32.argtypes = [fp, i64, i64, i64, i64, i64,
                                          fp, fp, fp, fp]
            lib.crop_peak_f32.restype = None
            _lib = lib
    return _lib


def crop_peak_native(heatmaps, k: int):
    """`crop_heatmaps_channels_last_np` for one chunk, in the flat staged
    layout: heatmaps (F, H, W, J) -> (crops (F, k*k*J) float32, origins
    (F, J, 2) float32 as (oy, ox), (H, W), box (F, J), total (F, J)),
    with k clipped to the map as the numpy crop clips it."""
    heat = np.asarray(heatmaps)
    if heat.ndim != 4:
        raise ValueError(f"crop_peak_native takes (F, H, W, J) maps, got "
                         f"shape {heat.shape}")
    f, h, w, j = heat.shape
    k = min(int(k), h, w)
    if not 0 < j <= MAX_J or k < 1:
        raise ValueError(f"crop_peak_native: J={j} (at most {MAX_J}) and "
                         f"k={k} (at least 1) outside the kernel's range")
    heat = np.ascontiguousarray(heat, dtype=np.float32)
    crops = np.empty((f, k * k * j), np.float32)
    origins = np.empty((f, j, 2), np.float32)
    box = np.empty((f, j), np.float32)
    total = np.empty((f, j), np.float32)
    pf = ctypes.POINTER(ctypes.c_float)
    _library().crop_peak_f32(
        heat.ctypes.data_as(pf), f, h, w, j, k, crops.ctypes.data_as(pf),
        origins.ctypes.data_as(pf), box.ctypes.data_as(pf),
        total.ctypes.data_as(pf))
    return crops, origins, (h, w), box, total
