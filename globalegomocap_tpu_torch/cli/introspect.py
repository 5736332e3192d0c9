"""Prior introspection CLI: sample / interpolate / latent-stats.

Counterpart of `globalegomocap_tpu/cli/introspect.py` (the reference's
networks/sample.py, networks/interpolant.py and networks/get_latent.py
behind one entry point), with the JAX CLI's subcommands, flags, defaults
and printed lines:

    python -m globalegomocap_tpu_torch.cli.introspect sample \\
        --ckpt <prior> --out out/sample --num 10
    python -m globalegomocap_tpu_torch.cli.introspect interpolate \\
        --ckpt <prior> --data <windows.pkl> --i 0 --j 5 --out out/interp
    python -m globalegomocap_tpu_torch.cli.introspect latent-stats \\
        --ckpt <prior> --data <windows.pkl>

The prior is a ConvVAE of --latent_dim and --seq_len at the reference's
hidden widths (64, 64, 128, 256, 512), read by
`models/checkpoint.py::load_prior_variables` (flax msgpack, an Orbax
directory, or a torch .pth.tar / state dict; a directory that is no
Orbax checkpoint raises FileNotFoundError naming its missing
manifest.ocdbt).
--data is a pickle of (W, T, 45) windows.  `sample` writes
<out>/sample_<i>/out_<frame>.ply, `interpolate` <out>/<k>/out_<frame>.ply
(k = 0 .. steps + 1).  Runs on the card unless --device cpu; sampling
draws JAX's latents of --seed (`normal(PRNGKey(seed), (num,
latent_dim))`) on that device, so `sample` writes the JAX CLI's motions.
`main` returns what it computed: the sampled or interpolated motions
(N, T, 15, 3), or `tools/prior_tools.py::latent_statistics`'s dict.
"""

from __future__ import annotations

import argparse
import os
import pickle

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = p.add_subparsers(dest="cmd", required=True)
    for name in ("sample", "interpolate", "latent-stats"):
        s = sub.add_parser(name)
        s.add_argument("--ckpt", required=True, type=str)
        s.add_argument("--latent_dim", default=2048, type=int)
        s.add_argument("--seq_len", default=10, type=int)
        s.add_argument("--device", default="cuda", type=str,
                       help="cuda (default) or cpu")
        if name == "sample":
            s.add_argument("--out", required=True, type=str)
            s.add_argument("--num", default=10, type=int)
            s.add_argument("--seed", default=0, type=int)
        else:
            s.add_argument("--data", required=True, type=str,
                           help="pickle of (W, T, 45) windows")
        if name == "interpolate":
            s.add_argument("--i", required=True, type=int)
            s.add_argument("--j", required=True, type=int)
            s.add_argument("--steps", default=4, type=int)
            s.add_argument("--out", required=True, type=str)
    return p


def load_prior(path: str, latent_dim: int, seq_len: int, device):
    """The ConvVAE at `path` on `device`, in eval mode."""
    from globalegomocap_tpu_torch.cli.serve import check_state
    from globalegomocap_tpu_torch.models.checkpoint import (
        load_prior_variables)
    from globalegomocap_tpu_torch.models.conv_vae import ConvVAE
    from globalegomocap_tpu_torch.models.convert import params_from_flax
    model = ConvVAE(latent_dim=latent_dim, seq_len=seq_len)
    state = params_from_flax(load_prior_variables(path, seq_len))
    model.load_state_dict(check_state(state, model, path))
    return model.to(device).eval()


def main(argv=None):
    args = build_parser().parse_args(argv)

    from globalegomocap_tpu_torch.device import resolve_device
    from globalegomocap_tpu_torch.tools import prior_tools

    model = load_prior(args.ckpt, args.latent_dim, args.seq_len,
                       resolve_device(args.device))

    if args.cmd == "sample":
        motions = prior_tools.export_sample_meshes(model, args.out,
                                                   args.num, args.seed)
        print(f"wrote {args.num} sampled motions to {args.out}")
        return motions

    with open(args.data, "rb") as f:
        windows = np.asarray(pickle.load(f), dtype=np.float32)
    windows = windows.reshape(len(windows), args.seq_len, 45)

    if args.cmd == "interpolate":
        from globalegomocap_tpu_torch.tools.ply import save_skeleton_sequence
        out = prior_tools.interpolate_latents(
            model, windows[args.i], windows[args.j], args.steps)
        for k, motion in enumerate(out):
            save_skeleton_sequence(motion, os.path.join(args.out, str(k)))
        print(f"wrote {len(out)} interpolated motions to {args.out}")
        return out

    stats = prior_tools.latent_statistics(model, windows)
    print(f"mean ||mu||^2: {stats['mean_mu_sq_norm']:.4f}")
    print(f"mean ||std - 1||^2: {stats['mean_std_dist']:.4f}")
    return stats


if __name__ == "__main__":
    main()
