"""Offline tooling: preprocessing ETL (SLAM, BVH, heatmap lifting), prior
introspection (sampling, interpolation, latent stats), mesh export and
2D drawing."""
