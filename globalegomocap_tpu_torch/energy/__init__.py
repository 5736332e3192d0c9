"""Energy terms of the latent-space pose optimization."""

from globalegomocap_tpu_torch.energy.terms import (  # noqa: F401
    EnergyWeights,
    bone_length_energy,
    heatmap_energy,
    pose_energy_3d,
    reprojection_energy,
    smooth_acceleration_energy,
    soft_smooth_energy,
    total_energy_from_pose,
    vae_energy,
)
