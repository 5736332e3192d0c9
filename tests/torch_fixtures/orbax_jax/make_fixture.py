"""Writes the Orbax fixture the PyTorch port's tests read, with the JAX
package's own writers (orbax 0.11 through `ocp.StandardCheckpointer`):

- `prior.orbax/`: `models/checkpoint.py::save_orbax` of a tiny ConvVAE
  prior (latent 16, seq_len 10, hidden 8, 8, 16, 16, 32): the trainer's
  initial parameters (PRNGKey(0)) with BatchNorm running statistics
  drawn from numpy (seed 0);
- `checkpoints/0.orbax/` and `checkpoints/0.json`: the JAX
  `Trainer.save_checkpoint(fmt="orbax")` after one epoch of that prior
  (one device, Adam at lr 1e-3, batch 16) on `synthetic_amass(12, 40,
  seed=9)`'s local-pose windows, 22 steps;
- `expected.npz`: every array leaf of the two, as JAX's `load_orbax`
  restores them, under '/'-joined key paths prefixed 'prior/' and
  'epoch/'.

    JAX_PLATFORMS=cpu python tests/torch_fixtures/orbax_jax/make_fixture.py

rewrites the fixture beside this script; `build(out)` writes it under
`out`.  Data file names and timestamps differ from run to run, the
leaves do not (tests/test_torch_orbax.py checks).
"""

import os
import shutil
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(HERE)))
sys.path.insert(0, ROOT)

HIDDEN = (8, 8, 16, 16, 32)
LATENT = 16
TRAIN = dict(latent_dim=LATENT, seq_length=10, epochs=1, batch_size=16,
             kl_weight=0.1, learning_rate=1e-3, local_pose=True,
             log_step=0, num_devices=1)


def leaves(tree, prefix):
    """{'<prefix>/<key>/...': array} of a restored tree."""
    import numpy as np
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(leaves(v, f"{prefix}/{k}"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(leaves(v, f"{prefix}/{i}"))
    elif tree is not None:
        out[prefix] = np.asarray(tree)
    return out


def build(out: str) -> dict:
    """Write the fixture under `out`; returns its leaves."""
    import jax
    import numpy as np
    from globalegomocap_tpu.config import TrainConfig
    from globalegomocap_tpu.data.amass import AmassWindows
    from globalegomocap_tpu.data.synthetic import synthetic_amass
    from globalegomocap_tpu.models.checkpoint import load_orbax, save_orbax
    from globalegomocap_tpu.models.conv_vae import ConvVAE
    from globalegomocap_tpu.train.train_vae import Trainer

    windows = AmassWindows.from_sequences(
        synthetic_amass(n_sequences=12, frames_per_seq=40, seed=9),
        frame_num=10, local_pose=True)
    model = ConvVAE(latent_dim=LATENT, seq_len=10, hidden_dims=HIDDEN)
    trainer = Trainer(TrainConfig(**TRAIN), windows,
                      AmassWindows(windows.windows[:32]), model)
    # the prior: the trainer's initial parameters (PRNGKey(0)) with
    # running statistics from numpy
    v = jax.device_get(trainer.variables)
    rng = np.random.default_rng(0)
    stats = {name: {"bn": {
        "mean": rng.uniform(-0.1, 0.1, s["bn"]["mean"].shape).astype(
            np.float32),
        "var": rng.uniform(0.8, 1.2, s["bn"]["var"].shape).astype(
            np.float32)}} for name, s in sorted(v["batch_stats"].items())}
    prior = os.path.join(out, "prior.orbax")
    save_orbax({"params": v["params"], "batch_stats": stats}, prior)
    trainer.train(log_fn=lambda *_: None)
    epoch = trainer.save_checkpoint(os.path.join(out, "checkpoints"), 0,
                                    trainer.evaluate(), fmt="orbax")
    got = leaves(load_orbax(prior), "prior")
    got.update(leaves(load_orbax(epoch), "epoch"))
    np.savez_compressed(os.path.join(out, "expected.npz"), **got)
    return got


if __name__ == "__main__":
    import jax
    jax.config.update("jax_platforms", "cpu")
    for name in ("prior.orbax", "checkpoints", "expected.npz"):
        path = os.path.join(HERE, name)
        if os.path.isdir(path):
            shutil.rmtree(path)
        elif os.path.exists(path):
            os.remove(path)
    got = build(HERE)
    print(f"wrote {len(got)} leaves under {HERE}")
