"""PyTorch/CUDA port of GlobalEgoMocap (the JAX package `globalegomocap_tpu`
is the reference).

This slice runs the serve path's two-stage latent solve: host staging of
heatmap peak crops, the batched fixed-iteration L-BFGS over the conv
decoder plus the fused stage-1 energy kernel, the residual global stage
over the no-reproj kernel, the overlap merge and the 17-metric suite.
The two energy kernels are hand-written CUDA for Hopper
(`csrc/fused_energy.cu`, bound in `ops/fused_energy.py`).

The package imports neither `jax` nor anything of `globalegomocap_tpu`.
Entry points run on the card unless the caller passes `device="cpu"`
(`device.resolve_device`).
"""

from globalegomocap_tpu_torch.device import resolve_device  # noqa: F401
