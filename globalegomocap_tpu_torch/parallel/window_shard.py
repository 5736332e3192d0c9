"""The window-sharded solve: one chunk's windows over the ranks of a mesh.

Counterpart of `globalegomocap_tpu/parallel/window_shard.py`.  The
chunk-sharded batched solve (`optimize/driver.py`) cannot give one long
sequence more than one card; this solve shards the window axis of one
chunk instead.  The windows are independent through both stages, and
their only coupling, the overlap merge, follows one `all_gather` of the
solved windows:

- the windows are edge-padded to a multiple of the mesh size, and each
  rank solves its slice with `pipeline.solve_windows` (its kernels
  launch as often as on one rank, on fewer rows);
- one `all_gather` collects the five `WindowFields` (one float32
  buffer);
- the padding is sliced off before the merge, so that no duplicate
  window weighs in an overlap mean, and every rank merges.

On a mesh of one rank it is `pipeline.optimize_chunk`: no padding and no
collective.
"""

from __future__ import annotations

from globalegomocap_tpu_torch.config import OptimizeConfig
from globalegomocap_tpu_torch.ops import fisheye
from globalegomocap_tpu_torch.optimize.pipeline import (
    ChunkResult, WindowFields, check_supported, merge_window_fields,
    solve_windows, window_chunk_inputs)
from globalegomocap_tpu_torch.parallel.mesh import (
    Mesh, all_gather_fields, make_mesh, pad_to_multiple, window_sharding)


def optimize_chunk_window_sharded(
        local_model, global_model, estimated_local, camera_seq, heatmap_seq,
        gt_seq, camera: fisheye.FisheyeParams, cfg: OptimizeConfig,
        mesh: Mesh | None = None, origins=None,
        full_hw=None) -> ChunkResult:
    """One chunk's two-stage solve with its window axis sharded over
    `mesh` (default `make_mesh()` on the inputs' device), under
    `pipeline.optimize_chunk`'s argument contract (raw maps, or staged
    crops with `origins` and `full_hw`) and with its result.  The joint
    solve of energy.overlap_consistency couples the windows, so it is
    refused."""
    if float(cfg.energy.overlap_consistency) != 0.0:
        raise ValueError(
            "the window-sharded solve needs independent windows; "
            "energy.overlap_consistency couples them: use the one-rank "
            "optimize_chunk for the joint solve")
    check_supported(cfg)
    if mesh is None:
        mesh = make_mesh(device=estimated_local.device)
    (win_local, win_cam, win_heat, win_gt, win_bl, win_org,
     full_hw) = window_chunk_inputs(estimated_local, camera_seq,
                                    heatmap_seq, gt_seq, camera, cfg,
                                    origins, full_hw)
    n_win = win_local.shape[0]
    if mesh.size == 1:
        return merge_window_fields(solve_windows(
            local_model, global_model, win_local, win_cam, win_heat, win_gt,
            win_bl, camera, cfg, win_org=win_org, full_hw=full_hw), cfg)

    def mine(x):
        return None if x is None else window_sharding(
            mesh, pad_to_multiple(x, mesh.size)[0])

    fields = solve_windows(local_model, global_model, mine(win_local),
                           mine(win_cam), mine(win_heat), mine(win_gt),
                           mine(win_bl), camera, cfg, win_org=mine(win_org),
                           full_hw=full_hw)
    gathered = all_gather_fields(mesh, fields)
    return merge_window_fields(
        WindowFields(*(f[:n_win] for f in gathered)), cfg)
