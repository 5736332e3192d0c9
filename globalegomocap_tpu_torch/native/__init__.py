"""Native (C) host-side kernels of the serving runtime: the ingest
peak-crop pass (`hostcrop`), used by `SequenceOptimizer.stage(on_host=True)`.
The port has no fallback when the build fails, so the JAX package's
`native_available` has no counterpart."""

from globalegomocap_tpu_torch.native.hostcrop import (  # noqa: F401
    crop_peak_native)
