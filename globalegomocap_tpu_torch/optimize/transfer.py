"""Moving a chunk's full heatmaps to the card in their own memory order.

A chunk's maps are a logical (F, H, W, J) array, but the generators and
many decoders render them channels first and hand over a transposed view
of that memory.  `memory_order` finds the C-contiguous view of the same
bytes and the permutation back to the logical axes, so the host copies
them once, as they lie, and the card reorders them (`optimize/driver.py`,
`SequenceOptimizer._put_maps`).  `PinnedRing` holds the pinned host
slots those copies go through, allocated once and reused across requests.
"""

from __future__ import annotations

import collections
import contextlib
import threading

import numpy as np
import torch

from globalegomocap_tpu_torch.utils.profiling import RECORDER


def memory_order(x: np.ndarray) -> tuple[np.ndarray | None, tuple]:
    """(view, perm) with `view.transpose(perm)` equal to `x`: `view` is a
    C-contiguous float32 view of x's memory (its axes sorted by stride,
    no copy), `perm` the permutation that restores x's axes (the identity
    for a C-contiguous x).  Where x is not float32, or no permutation of
    its axes is C-contiguous (a strided slice, a broadcast, a negative
    stride), `view` is None and `perm` the identity: the caller copies x
    in its logical order, casting as it goes."""
    x = np.asarray(x)
    ident = tuple(range(x.ndim))
    if x.dtype != np.float32:
        return None, ident
    order = sorted(ident, key=lambda a: -x.strides[a])
    view = x.transpose(order)
    if not view.flags.c_contiguous:
        return None, ident
    return view, tuple(int(a) for a in np.argsort(order))


def fill(dst: torch.Tensor, x: np.ndarray) -> None:
    """Copy `x` into the host tensor `dst` of its shape in one pass,
    casting to dst's dtype: torch's copy (on several threads) where torch
    can read x's memory, numpy's where it cannot (a negative stride, a
    byte order not the machine's)."""
    if x.dtype.isnative and min(x.strides, default=0) >= 0:
        dst.copy_(torch.from_numpy(x))
    else:
        np.copyto(dst.numpy(), x, casting="unsafe")


class PinnedRing:
    """A few pinned host slots that host-to-device copies go through,
    reused across requests.  A slot is allocated on its first use and
    grows only for a copy larger than it; `slot` hands out the slot freed
    longest ago once the copy last enqueued from it has finished (the
    wait is the span `stage.ring_wait`), and on leaving records an event
    on the current stream, after the copy the caller enqueued.  A lock
    guards the hand-out: several threads (the prefetch worker, an inline
    `submit_batch`) may stage through one ring at once.  Two slots let
    one chunk's fill overlap the previous chunk's copy."""

    def __init__(self, slots: int = 2):
        self._cond = threading.Condition()
        self._free = collections.deque([(None, None)] * slots)

    def sizes(self) -> list[int]:
        """The bytes of each allocated slot not in use."""
        with self._cond:
            return [b.numel() for b, _ in self._free if b is not None]

    @contextlib.contextmanager
    def slot(self, nbytes: int, device: torch.device):
        """A pinned uint8 host tensor of at least `nbytes` bytes, free to
        fill; enqueue its copy to `device` on the current stream before
        leaving."""
        with RECORDER.span("stage.ring_wait"):
            with self._cond:
                while not self._free:
                    self._cond.wait()
                buf, done = self._free.popleft()
            if done is not None:
                done.synchronize()
        try:
            if buf is None or buf.numel() < nbytes:
                buf = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
            yield buf
        finally:
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(device))
            with self._cond:
                self._free.append((buf, done))
                self._cond.notify()
