"""Throughput accounting.

Counterpart of `ThroughputMeter` in `globalegomocap_tpu/utils/profiling.py`
(the span timer and the device trace of that module wait for a later
slice).
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass

import torch


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
