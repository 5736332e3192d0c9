"""Build test_data.pkl chunks from raw heatmaps, depths, SLAM and GT.

Counterpart of `globalegomocap_tpu/cli/preprocess.py`, the CLI of the
preprocessing ETL (`tools/process_test_data.py`; the reference's
MakeDataForOptimization/process_test_data.py:167-184), with the JAX
CLI's flags and defaults:

    python -m globalegomocap_tpu_torch.cli.preprocess \\
        --slam data/seq/frame_trajectory.txt \\
        --heatmap_dir .../heatmaps --depth_dir .../depths \\
        --gt data/seq/gt.pkl --out corrected_data/seq \\
        --start 551 --end 3300 [--fps 25] [--chunk 100] \\
        [--mat_start_frame N] [--calibration cam.json] [--device cpu]

The lift and the SLAM fit run on the card unless --device cpu; the .mat
files are read on the host.  Prints one `chunk s..e: initial mpjpe`
line a chunk and returns the written paths.
"""

from __future__ import annotations

import argparse


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--slam", required=True, type=str)
    p.add_argument("--heatmap_dir", required=True, type=str)
    p.add_argument("--depth_dir", required=True, type=str)
    p.add_argument("--gt", required=True, type=str)
    p.add_argument("--out", required=True, type=str)
    p.add_argument("--start", required=True, type=int)
    p.add_argument("--end", required=True, type=int)
    p.add_argument("--fps", default=25.0, type=float)
    p.add_argument("--chunk", default=100, type=int)
    p.add_argument("--mat_start_frame", default=None, type=int)
    p.add_argument("--calibration", default=None, type=str)
    p.add_argument("--device", default="cuda", type=str,
                   help="cuda (default) or cpu")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)

    from globalegomocap_tpu_torch.device import resolve_device
    from globalegomocap_tpu_torch.tools.process_test_data import (
        process_sequence)
    return process_sequence(
        args.slam, args.heatmap_dir, args.depth_dir, args.gt, args.out,
        args.start, args.end, fps=args.fps, chunk_size=args.chunk,
        mat_start_frame=args.mat_start_frame,
        calibration_path=args.calibration,
        device=resolve_device(args.device))


if __name__ == "__main__":
    main()
