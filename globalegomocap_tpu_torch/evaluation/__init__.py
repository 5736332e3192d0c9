"""The 17-metric MPJPE suite."""

from globalegomocap_tpu_torch.evaluation.metrics import (  # noqa: F401
    METRIC_KEYS, align_per_frame, align_sequence_globally, calculate_errors,
    camera_position_error, mpjpe)
