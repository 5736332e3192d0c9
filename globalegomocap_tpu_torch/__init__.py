"""PyTorch/CUDA port of GlobalEgoMocap (the JAX package `globalegomocap_tpu`
is the reference).

Two paths run: the serve path's flat two-stage latent solve (host
staging of heatmap peak crops, or of the full maps when the crop-mass
guard falls back, the batched fixed-iteration L-BFGS over the conv
decoder with the fused energy kernels, the residual global stage, the
overlap merge and the 17-metric suite), and the per-chunk path of the
reference-parity CLI (per-window L-BFGS over full maps or crops cut on
the device).  Their kernels are hand-written CUDA for Hopper under
`csrc/`: the fused stage energies (`ops/fused_energy.py`), the full-map
heatmap sampler (`ops/heatmap_sample.py`) and the L-BFGS direction
(`ops/lbfgs_direction.py`), built and bound by `ops/cuda_build.py`.

The package imports neither `jax` nor anything of `globalegomocap_tpu`.
Entry points run on the card unless the caller passes `device="cpu"`
(`device.resolve_device`).
"""

from globalegomocap_tpu_torch.device import resolve_device  # noqa: F401
