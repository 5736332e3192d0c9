"""Train the motion-VAE prior (relative-global or local-pose) on one card
or data-parallel over several.

The PyTorch counterpart of `globalegomocap_tpu/cli/train.py`, with its
parser flag for flag and default for default (the reference's training
surface, networks/config.py and its four launch scripts: latent 2048,
kl 0.5, seq 10, batch 64, fps 25), plus --device:

    python -m globalegomocap_tpu_torch.cli.train \\
        --train_data_path <amass_pkl_dir> [--local_pose true] \\
        [--with_mo2cap2_names <names.txt>] [--data_balance true] \\
        [--checkpoint_format orbax] \\
        [--resume logs/<dir>/checkpoints/<epoch>.{msgpack,orbax}] \\
        [--device cpu]

--hdf5 true reads a file of `data/hdf5.py::pack_amass_dir` whole (its
last max(1, n // 20) windows are the test split); --hdf5_stream true
streams the same split from the file (`HDF5WindowStream`), for corpora
that do not fit in memory.  Checkpoints go to logs/<log_dir>/checkpoints
as <epoch>.msgpack (the JAX trainer's file), or <epoch>.orbax (an Orbax
directory, `models/orbax.py`) at --checkpoint_format orbax, and
<epoch>.json; --resume takes either.

--num_devices N above 1 trains data-parallel on N ranks, one process
each (`parallel/mesh.py::spawn`): NCCL over cuda:0..N-1, or gloo over N
CPU processes with --device cpu.  0 (the default) means every visible
card, one process where one card is visible; more ranks than cards
raises ValueError.  Every rank reads the same batches of any data source
and trains on its rows; rank 0 prints and writes the checkpoints.
"""

from __future__ import annotations

import argparse
import datetime
import os


def str2bool(x: str) -> bool:
    return str(x).lower() == "true"


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--train_data_path", required=True, type=str)
    p.add_argument("--latent_dim", default=2048, type=int)
    p.add_argument("--seq_length", default=10, type=int)
    p.add_argument("--fps", default=25, type=int)
    p.add_argument("--kl_weight", default=0.5, type=float)
    p.add_argument("--epoch", default=20, type=int)
    p.add_argument("--batch_size", default=64, type=int)
    p.add_argument("--learning_rate", default=1e-4, type=float)
    p.add_argument("--lr_schedule", default="constant",
                   choices=["constant", "cosine"],
                   help="'cosine': warmup, then cosine decay to --lr_final "
                        "over the whole run (the reference only has "
                        "constant)")
    p.add_argument("--lr_warmup_steps", default=0, type=int)
    p.add_argument("--lr_final", default=0.0, type=float)
    p.add_argument("--logvar_init_bias", default=0.0, type=float,
                   help="initial bias of the VAE log-variance head; "
                        "negative (e.g. -6) starts the posterior "
                        "near-deterministic")
    p.add_argument("--weight_decay", default=0.0, type=float)
    p.add_argument("--compute_dtype", default="float32",
                   choices=["float32", "bfloat16"],
                   help="compute dtype of the encoder and decoder "
                        "(parameters, optimizer state and loss stay "
                        "float32)")
    p.add_argument("--slide_window_step", default=1, type=int)
    p.add_argument("--data_balance", default=False, type=str2bool)
    p.add_argument("--local_pose", default=False, type=str2bool,
                   help="train the local-pose prior (train_local.py "
                        "equivalent) instead of the relative-global prior")
    p.add_argument("--with_mo2cap2_names", default=None, type=str,
                   help="path to a text/npy file of sequence names to "
                        "restrict training to (mo2cap2 subset)")
    p.add_argument("--log_dir", default=None, type=str)
    p.add_argument("--log_step", default=100, type=int)
    p.add_argument("--epoch_scan", default=False, type=str2bool,
                   help="run each epoch in blocks of steps with no host "
                        "readback inside a block (one log line an epoch)")
    p.add_argument("--eval_every", default=1, type=int,
                   help="evaluate/checkpoint every N epochs "
                        "(always on the last)")
    p.add_argument("--resume", default=None, type=str,
                   help="path to an epoch .msgpack checkpoint to resume")
    p.add_argument("--num_devices", default=0, type=int,
                   help="devices for data parallelism (0 = all)")
    p.add_argument("--hdf5", default=False, type=str2bool,
                   help="train_data_path is a packed HDF5 file")
    p.add_argument("--hdf5_stream", default=False, type=str2bool,
                   help="stream batches from the HDF5 file instead of "
                        "materializing all windows (AMASS scale)")
    p.add_argument("--checkpoint_format", default="msgpack",
                   choices=["msgpack", "orbax"])
    p.add_argument("--device", default="cuda", type=str,
                   help="'cuda' (the default) or 'cpu'")
    return p


def load_mo2cap2_names(path: str | None):
    if path is None:
        return None
    if path.endswith(".npy"):
        import numpy as np
        return [str(x) for x in np.load(path, allow_pickle=True).tolist()]
    with open(path) as f:
        return [line.strip() for line in f if line.strip()]


def ranks_for(num_devices: int, device) -> int:
    """The number of ranks --num_devices asks for on `device`: on the
    card, 0 is every visible card and more than are visible raises
    ValueError naming both counts; on the CPU, 0 is one rank."""
    import torch
    if device.type != "cuda":
        return max(1, num_devices)
    cards = torch.cuda.device_count()
    if num_devices > cards:
        raise ValueError(f"--num_devices {num_devices} asks for more ranks "
                         f"than the {cards} visible card(s)")
    return num_devices or cards


def main(argv=None):
    """Train as the flags say: returns the trainer, or over several
    ranks rank 0's {'step', 'history'}."""
    args = build_parser().parse_args(argv)

    import torch.distributed as dist

    from globalegomocap_tpu_torch.device import resolve_device
    from globalegomocap_tpu_torch.parallel.mesh import make_mesh, spawn

    device = resolve_device(args.device)
    args.log_dir = args.log_dir or datetime.datetime.now().strftime(
        "%m.%d-%H.%M.%S")
    if dist.is_available() and dist.is_initialized():   # under torchrun
        return train(args, make_mesh(
            args.num_devices or None,
            device=None if device.type == "cuda" else device))
    world = ranks_for(args.num_devices, device)
    if world == 1:
        return train(args, make_mesh(device=device))
    devices = ([f"cuda:{i}" for i in range(world)] if device.type == "cuda"
               else ["cpu"] * world)
    return spawn(train_rank, world, devices, args=(args,))[0]


def train_rank(mesh, args) -> dict:
    """One rank of a data-parallel run: {'step', 'history'}."""
    trainer = train(args, mesh)
    return {"step": trainer.step, "history": trainer.history}


def train(args, mesh):
    """The run on this rank of `mesh`; returns the trainer."""
    trainer = build_trainer(args, mesh)
    ckpt_dir = os.path.join("logs", args.log_dir, "checkpoints")
    trainer.train(checkpoint_dir=ckpt_dir,
                  checkpoint_format=args.checkpoint_format)
    return trainer


def build_trainer(args, mesh):
    """The datasets and the trainer of the flags on this rank of `mesh`
    (resumed from --resume), before any step."""
    from globalegomocap_tpu_torch.config import TrainConfig
    from globalegomocap_tpu_torch.data.amass import AmassWindows
    from globalegomocap_tpu_torch.train.train_vae import Trainer

    cfg = TrainConfig(
        train_data_path=args.train_data_path,
        latent_dim=args.latent_dim, seq_length=args.seq_length,
        fps=args.fps, kl_weight=args.kl_weight, epochs=args.epoch,
        batch_size=args.batch_size, learning_rate=args.learning_rate,
        lr_schedule=args.lr_schedule,
        lr_warmup_steps=args.lr_warmup_steps, lr_final=args.lr_final,
        logvar_init_bias=args.logvar_init_bias,
        compute_dtype=args.compute_dtype,
        weight_decay=args.weight_decay,
        slide_window_step=args.slide_window_step,
        data_balance=args.data_balance, local_pose=args.local_pose,
        log_step=args.log_step, num_devices=args.num_devices,
        epoch_scan=args.epoch_scan, eval_every=args.eval_every)

    names = load_mo2cap2_names(args.with_mo2cap2_names)
    if args.hdf5_stream:
        from globalegomocap_tpu_torch.data.hdf5 import HDF5WindowStream
        probe = HDF5WindowStream(args.train_data_path,
                                 local_pose=args.local_pose)
        n_test = max(1, len(probe) // 20)
        probe.close()
        train_ds = HDF5WindowStream(args.train_data_path,
                                    local_pose=args.local_pose,
                                    stop=-n_test)
        test_ds = HDF5WindowStream(args.train_data_path,
                                   local_pose=args.local_pose,
                                   start=-n_test)
    elif args.hdf5:
        from globalegomocap_tpu_torch.data.hdf5 import load_hdf5_windows
        full = load_hdf5_windows(args.train_data_path,
                                 local_pose=args.local_pose)
        n_test = max(1, len(full.windows) // 20)
        train_ds = AmassWindows(full.windows[:-n_test])
        test_ds = AmassWindows(full.windows[-n_test:])
    else:
        train_ds, test_ds = (AmassWindows.from_dir(
            args.train_data_path, frame_num=args.seq_length, fps=args.fps,
            is_train=is_train, local_pose=args.local_pose,
            balance_walking=args.data_balance, mo2cap2_names=names,
            dilation=args.slide_window_step) for is_train in (True, False))

    if mesh.rank == 0:
        print(f"train windows: {len(train_ds)}, test windows: "
              f"{len(test_ds)}")

    trainer = Trainer(cfg, train_ds, test_ds, mesh=mesh)
    if args.resume:
        trainer.load_checkpoint(args.resume)
    return trainer


if __name__ == "__main__":
    main()
