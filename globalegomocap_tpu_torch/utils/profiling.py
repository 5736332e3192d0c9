"""Throughput accounting and the device trace.

Counterparts of `ThroughputMeter` and `device_trace` in
`globalegomocap_tpu/utils/profiling.py` (its span timer waits for a later
slice).  The trace is torch.profiler's Chrome trace, where the JAX
package writes jax.profiler's TensorBoard trace.
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass

import torch


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Trace the block with torch.profiler (host operators, and the card's
    kernels where CUDA is available) and write it as a Chrome trace,
    `log_dir`/trace_<pid>.json (open it in chrome://tracing or
    Perfetto)."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir,
                                          f"trace_{os.getpid()}.json"))


@dataclass
class ThroughputMeter:
    """windows/sec (or any unit/sec) accounting."""
    unit: str = "windows"
    total_units: float = 0.0
    total_seconds: float = 0.0

    @contextlib.contextmanager
    def measure(self, units: float, sync_value=None):
        """Time the block; with `sync_value` (a tensor) the clock stops
        only after the card has finished the work queued so far on that
        tensor's device (nothing to wait for on the CPU)."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync_value is not None and sync_value.device.type == "cuda":
                torch.cuda.synchronize(sync_value.device)
            self.total_seconds += time.perf_counter() - t0
            self.total_units += units

    @property
    def rate(self) -> float:
        return self.total_units / self.total_seconds \
            if self.total_seconds else 0.0

    def report(self) -> str:
        return f"{self.rate:.2f} {self.unit}/s " \
               f"({self.total_units:.0f} {self.unit} in " \
               f"{self.total_seconds:.2f}s)"
