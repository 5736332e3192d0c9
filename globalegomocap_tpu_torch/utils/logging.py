"""Training and evaluation metric logging: JSONL always, TensorBoard too
when `torch.utils.tensorboard` imports.

Counterpart of `globalegomocap_tpu/utils/logging.py`: one append-only
`metrics.jsonl` record ({"t", "name", "value", "step"}) a scalar under
`log_dir`, mirrored to a SummaryWriter under `log_dir`/tensorboard.
Whether TensorBoard is written depends only on what is installed (and on
`tensorboard`); it is a choice of output, not of device.
"""

from __future__ import annotations

import json
import os
import time


class MetricLogger:
    def __init__(self, log_dir: str, tensorboard: bool = True):
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, "metrics.jsonl")
        self._f = open(self.path, "a")
        self._tb = None
        if tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter
                self._tb = SummaryWriter(os.path.join(log_dir,
                                                      "tensorboard"))
            except Exception:  # noqa: BLE001 - no TensorBoard: JSONL only
                self._tb = None

    @property
    def tensorboard(self) -> bool:
        """Whether the scalars also go to TensorBoard."""
        return self._tb is not None

    def scalar(self, name: str, value: float, step: int):
        self._f.write(json.dumps({"t": time.time(), "name": name,
                                  "value": float(value),
                                  "step": int(step)}) + "\n")
        self._f.flush()
        if self._tb is not None:
            self._tb.add_scalar(name, float(value), int(step))

    def close(self):
        self._f.close()
        if self._tb is not None:
            self._tb.close()
