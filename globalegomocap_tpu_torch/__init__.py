"""PyTorch/CUDA port of GlobalEgoMocap (the JAX package `globalegomocap_tpu`
is the reference).

Three paths run: the serve path's flat two-stage latent solve (streamed
with stage prefetching and a bounded in-flight depth,
`optimize/streaming.py`; staging of heatmap peak crops on the host or
the device, or of the full maps when the crop-mass guard falls back, the
batched fixed-iteration L-BFGS over the conv, dense or shift decoder with
the fused energy kernels, the residual global stage, the overlap merge
and the 17-metric suite), the per-chunk path of the
reference-parity CLI (per-window L-BFGS over full maps or crops cut on
the device), and the dataset sweep of `cli/evaluate_all.py` (one flat
solve a sequence, on flax msgpack or torch priors).  Their kernels are
hand-written CUDA for Hopper under `csrc/`: the fused stage energies
(`ops/fused_energy.py`, and with the decoder's conv chain
`ops/fused_decode_energy.py`), the full-map heatmap sampler
(`ops/heatmap_sample.py`) and the L-BFGS direction
(`ops/lbfgs_direction.py`), built and bound by `ops/cuda_build.py`.
Beside them run the prior training (`train/`), the preprocessing ETL and
prior introspection (`tools/`, `cli/`), the parallel paths
(`parallel/`), and the library the JAX package offers around them: the
robustness corpora (`data/synthetic.py::synthetic_chunk_v2` and `_v3`:
jerky motion, SLAM camera drift, occluded, multimodal and dropped-out
maps), the GMM pose prior (`ops/gmm.py`), the camera and 2D
reprojection energies, the bone-length ConvVAE, the Blender camera
conversions, skeleton drawing, span timing and metric logging.

The package imports neither `jax` nor anything of `globalegomocap_tpu`.
Entry points run on the card unless the caller passes `device="cpu"`
(`device.resolve_device`).
"""

from globalegomocap_tpu_torch.device import resolve_device  # noqa: F401

__version__ = "0.1.0"
