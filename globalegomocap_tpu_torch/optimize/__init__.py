"""The latent-space optimization runtime."""

from globalegomocap_tpu_torch.optimize.lbfgs import (  # noqa: F401
    adam_minimize, lbfgs_minimize)
from globalegomocap_tpu_torch.optimize.window import (  # noqa: F401
    merge_windows, num_windows, slice_windows)
