"""VAE training pipeline (data-parallel over `parallel/mesh.py`'s
ranks).  The JAX package's `TrainState` has no counterpart: the port's
Trainer holds the model and its torch optimizer."""

from globalegomocap_tpu_torch.train.train_vae import (  # noqa: F401
    Trainer, make_eval_step, make_train_step)
