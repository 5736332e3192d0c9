"""The tiny joint prior's one train step on the card and on the CPU,
each against a float64 run on the CPU: how far each float32 gradient is
from float64, and which leaky-ReLU inputs take the other slope.

The step of tests/test_torch_gpu.py::
test_joint_train_step_on_the_card_matches_the_cpu (the same windows,
init and noise).  The float64 run is the same modules with their float32
casts read as float64 (the port's BatchNorm computes in float32).  Needs
a card; imports nothing of JAX.  From the root of a checkout:

    python3 tests/torch_joint_grad_probe.py
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from globalegomocap_tpu_torch.config import TrainConfig  # noqa: E402
from globalegomocap_tpu_torch.data.hdf5 import (  # noqa: E402
    sequence_windows_with_cameras)
from globalegomocap_tpu_torch.data.synthetic import (  # noqa: E402
    synthetic_amass)
from globalegomocap_tpu_torch.models import (  # noqa: E402
    conv_vae, joint_vae)
from globalegomocap_tpu_torch.train import train_joint  # noqa: E402
from globalegomocap_tpu_torch.train.train_joint import (  # noqa: E402
    JointTrainer)

PRE: list = []      # each conv block's leaky-ReLU input, in call order


class _Float64:
    """`torch` with float32 read as float64."""

    def __getattr__(self, name):
        return torch.float64 if name == "float32" else getattr(torch, name)


def _block(self, blk, x, transposed, train=False):
    """ConvVAE._conv_block, keeping the leaky-ReLU input."""
    conv, bn = blk[0], blk[1]
    fn = F.conv_transpose1d if transposed else F.conv1d
    dt = self.dtype
    y = fn(x, conv.weight.to(dt), conv.bias.to(dt), padding=1)
    z = (conv_vae._batch_norm_train(bn, y.to(conv_vae.torch.float32))
         if train else F.batch_norm(
             y.to(conv_vae.torch.float32), bn.running_mean, bn.running_var,
             bn.weight, bn.bias, False, 0.0, bn.eps)).to(dt)
    PRE.append(z.detach().double().cpu())
    return F.leaky_relu(z, 0.01)


def step(device: str, f64: bool = False):
    """(gradients by name, leaky-ReLU inputs) of one joint train step."""
    parts = [sequence_windows_with_cameras(s, 10, 25, True)
             for s in synthetic_amass(2, 70, seed=3)]
    poses = np.concatenate([p[1] for p in parts]).reshape(-1, 10, 45)
    cams = np.concatenate([p[2] for p in parts])
    cfg = TrainConfig(latent_dim=32, batch_size=32, learning_rate=2e-3,
                      kl_weight=0.05)
    model = joint_vae.JointLocalGlobalVAE(latent_dim=32, seq_len=10,
                                          hidden_dims=(8, 8, 16, 16, 32))
    dt = torch.float64 if f64 else torch.float32
    t = JointTrainer(cfg, poses, cams, model, device=device)
    p, c = (torch.from_numpy(x[:32]).to(device, dt) for x in (poses, cams))
    draw = train_joint.joint_step_noise
    if f64:
        t.model.double()
        for m in (t.model, t.model.local_vae, t.model.global_vae):
            m.dtype = torch.float64
        # the float32 draws, read as float64
        train_joint.joint_step_noise = lambda *a, **k: tuple(
            n.double() for n in draw(*a[:3], torch.float32, *a[4:], **k))
    PRE.clear()
    try:
        t.train_step(p, c)
    finally:
        train_joint.joint_step_noise = draw
    grads = {k: v.grad.detach().double().cpu()
             for k, v in t.model.named_parameters()}
    return grads, list(PRE)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("torch_joint_grad_probe: needs a card")
    conv_vae.ConvVAE._conv_block = _block
    cpu, pre_cpu = step("cpu")
    card, pre_card = step("cuda")
    conv_vae.torch = joint_vae.torch = _Float64()
    ref, pre_ref = step("cpu", f64=True)
    rows = []
    for k, r in ref.items():
        if float(cpu[k].norm()) < 1e-6:
            continue                # a conv bias before BN: 0 but rounding
        m = float(r.abs().max())
        rows.append((float((card[k] - r).abs().max()) / m,
                     float((cpu[k] - r).abs().max()) / m,
                     float((card[k] - cpu[k]).norm() / cpu[k].norm()), k))
    print(f"{len(rows)} gradients held; max |g - g64| / max |g64|: card "
          f"{max(r[0] for r in rows):.3e}, CPU {max(r[1] for r in rows):.3e}"
          f"; card against CPU in relative L2 norm, worst "
          f"{max(r[2] for r in rows):.3e}")
    for r in sorted(rows, reverse=True)[:4]:
        print(f"  {r[3]}: card {r[0]:.3e}, CPU {r[1]:.3e}, L2 {r[2]:.3e}")
    print("leaky-ReLU inputs on the other side of 0 from float64's "
          "(blocks 0-9 the local branch: encoder 0-4, decoder 5-8, final "
          "9; 10-19 the global branch):")
    for i, (a, b, r) in enumerate(zip(pre_cpu, pre_card, pre_ref)):
        fc, fk = (a > 0) != (r > 0), (b > 0) != (r > 0)
        if fc.any() or fk.any():
            print(f"  block {i}: CPU {int(fc.sum())}, card {int(fk.sum())}"
                  f"; |z64| there {r[fc | fk].abs().tolist()}")
    print("  smallest |z64| of any block: "
          f"{min(float(r.abs().min()) for r in pre_ref):.3e}")


if __name__ == "__main__":
    main()
