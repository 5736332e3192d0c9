"""Device resolution and the float32 precision policy.

cuDNN runs float32 convolutions in TF32 by default, which keeps about
three decimal digits: the decoder convs would then silently lose the
millimetre resolution the metrics need (the same class of bug as the JAX
package's default-matmul-precision trap).  Importing this module pins
both matmuls and convolutions to full float32.
"""

from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    the CPU.  Without a card and without an explicit CPU request this
    raises instead of falling back."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port's plain PyTorch path on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
