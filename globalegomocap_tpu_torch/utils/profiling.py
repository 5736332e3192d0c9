"""Span timing, throughput accounting and the device trace.

Counterparts of `SpanTimer`, `ThroughputMeter` and `device_trace` in
`globalegomocap_tpu/utils/profiling.py`.  A `sync_value` tensor on a
CUDA device makes a span or a measurement end only after the card has
finished the work queued on that device (the JAX package's
`block_until_ready`).  The trace is torch.profiler's Chrome trace, where
the JAX package writes jax.profiler's TensorBoard trace.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from dataclasses import dataclass, field

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


def _wait_for(sync_value) -> None:
    """Wait for the card's queued work on `sync_value`'s device (nothing
    to wait for on the CPU)."""
    if sync_value is not None and sync_value.device.type == "cuda":
        torch.cuda.synchronize(sync_value.device)


@dataclass
class SpanTimer:
    """Named wall-clock spans; with `sync_value` (a tensor) a span ends
    only after the card has finished the work queued so far on that
    tensor's device."""
    spans: dict = field(default_factory=dict)

    @contextlib.contextmanager
    def span(self, name: str, sync_value=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            _wait_for(sync_value)
            self.spans.setdefault(name, []).append(
                time.perf_counter() - t0)

    def summary(self) -> dict:
        import numpy as np
        return {k: {"mean_s": float(np.mean(v)), "total_s": float(np.sum(v)),
                    "count": len(v)} for k, v in self.spans.items()}

    def report(self) -> str:
        return json.dumps(self.summary(), indent=1)


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
            _wait_for(sync_value)
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
