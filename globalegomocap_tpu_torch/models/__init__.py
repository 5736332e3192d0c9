"""Motion-prior models: the convolutional sequence VAE and its tooling."""

from globalegomocap_tpu_torch.models.conv_vae import (  # noqa: F401
    ConvVAE,
    VAEOutput,
    reparameterize,
    vae_loss,
)
