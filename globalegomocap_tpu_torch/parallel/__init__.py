"""The process-group mesh and the sharding helpers (`parallel/mesh.py`),
and the window-sharded solve of one chunk (`parallel/window_shard.py`)."""

from globalegomocap_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh, all_gather, all_reduce, make_mesh, pad_to_multiple, replicate,
    shard_batch, spawn, window_sharding)
