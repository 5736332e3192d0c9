"""The port stands alone: importing every module of
`globalegomocap_tpu_torch` loads neither `jax`, `flax`, `optax`, `msgpack`,
`orbax`, `tensorstore`, `zstandard`, `h5py`, `sklearn` nor anything of the
JAX package; with h5py and sklearn blocked it packs, reads and streams an
HDF5 corpus and loads a pickled sklearn GaussianMixture; and its entry
points run on the card unless told otherwise."""

import json
import os
import subprocess
import sys

import pytest
import torch

from globalegomocap_tpu_torch.device import resolve_device
from tests.torch_port_helpers import tcfg, slice_config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = """
import importlib, json, os, pickle, pkgutil, sys, tempfile
sys.modules["h5py"] = sys.modules["sklearn"] = None
import globalegomocap_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__,
                                               pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
from globalegomocap_tpu_torch.optimize.lbfgs import (  # noqa: F401
    adam_minimize, lbfgs_minimize)
from globalegomocap_tpu_torch.native.hostcrop import (  # noqa: F401
    crop_peak_native)
from globalegomocap_tpu_torch.data import hdf5
from globalegomocap_tpu_torch.data.synthetic import synthetic_amass
from globalegomocap_tpu_torch.ops.gmm import load_sklearn_pickle
with tempfile.TemporaryDirectory() as tmp:
    os.mkdir(os.path.join(tmp, "amass"))
    for i, seq in enumerate(synthetic_amass(2, 40, seed=1)):
        with open(os.path.join(tmp, "amass", f"{i}.pkl"), "wb") as f:
            pickle.dump(seq, f)
    h5 = hdf5.pack_amass_dir(os.path.join(tmp, "amass"),
                             os.path.join(tmp, "c.h5"))
    n = len(hdf5.load_hdf5_windows(h5).windows)
    stream = hdf5.HDF5WindowStream(h5, slab_size=16)
    rows = sum(len(b) for b in stream.epoch_batches(
        __import__("numpy").random.default_rng(0), 4, drop_last=False))
    stream.close()
gmm = load_sklearn_pickle(os.path.join(
    "tests", "torch_fixtures", "gmm_sklearn", "full.pkl"))
bad = [m for m, mod in sys.modules.items() if mod is not None
       and m.split(".")[0] in ("jax", "flax", "optax", "msgpack", "h5py",
                               "sklearn", "orbax", "tensorstore",
                               "zstandard", "globalegomocap_tpu")]
print(json.dumps({"modules": names, "bad": bad, "windows": [n, rows],
                  "gmm": list(gmm.means.shape)}))
"""


def test_port_imports_no_jax():
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300,
                         check=True)
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    assert rec["bad"] == []
    assert rec["windows"] == [60, 60] and rec["gmm"] == [4, 45]
    for mod in ("cli.serve", "cli.optimize_sequence", "ops.cuda_build",
                "ops.fused_energy", "ops.fused_decode_energy",
                "ops.heatmap_sample",
                "ops.lbfgs_direction", "ops.sampling", "optimize.driver",
                "optimize.pipeline", "optimize.lbfgs", "models.convert",
                "data.synthetic", "native.hostcrop", "optimize.streaming",
                "utils.profiling", "models.dense_decoder",
                "cli.evaluate_all", "models.checkpoint", "tools.ply",
                "cli.train", "train.train_vae", "data.amass",
                "optimize.prior_bank", "models.joint_vae",
                "train.train_joint", "data.hdf5", "data.h5file",
                "data.mo2cap2",
                "cli.preprocess", "cli.introspect", "tools.process_test_data",
                "tools.slam_reader", "tools.bvh", "tools.captury_camera",
                "tools.prior_tools", "ops.epipolar", "native.zstd",
                "models.ocdbt", "models.orbax", "parallel.mesh",
                "parallel.window_shard"):
        assert "globalegomocap_tpu_torch." + mod in rec["modules"]


def test_entry_points_need_a_card_unless_cpu(monkeypatch, tmp_path):
    from globalegomocap_tpu_torch.cli import (
        evaluate_all, introspect, optimize_sequence, preprocess, serve,
        train)
    from globalegomocap_tpu_torch.optimize import driver
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    cfg = slice_config(tcfg)
    model = driver.build_model(cfg)
    sd = model.state_dict()
    with pytest.raises(RuntimeError):
        driver.SequenceOptimizer(model, sd, sd, cfg)
    assert driver.SequenceOptimizer(model, sd, sd, cfg,
                                    device="cpu").device.type == "cpu"
    ckpt = tmp_path / "prior.pt"
    torch.save(sd, ckpt)
    (tmp_path / "data").mkdir()
    with pytest.raises(RuntimeError):
        serve.main(["--data_root", str(tmp_path / "data"), "--local_ckpt",
                    str(ckpt), "--global_ckpt", str(ckpt),
                    "--latent_dim", "32", "--hidden_dims", "8,8,16,16,32"])
    with pytest.raises(RuntimeError):
        optimize_sequence.main([
            "--data_path", str(tmp_path / "data"), "--local_ckpt",
            str(ckpt), "--global_ckpt", str(ckpt), "--solver",
            "lbfgs_fixed", "--latent_dim", "32", "--hidden_dims",
            "8,8,16,16,32"])
    with pytest.raises(RuntimeError):
        evaluate_all.main(["--data_root", str(tmp_path / "data"),
                           "--local_ckpt", str(ckpt), "--global_ckpt",
                           str(ckpt), "--latent_dim", "32", "--hidden_dims",
                           "8,8,16,16,32"])
    with pytest.raises(RuntimeError):
        train.main(["--train_data_path", str(tmp_path / "data")])
    with pytest.raises(RuntimeError):
        preprocess.main(["--slam", "s", "--heatmap_dir", "h", "--depth_dir",
                         "d", "--gt", "g", "--out", str(tmp_path / "o"),
                         "--start", "0", "--end", "200"])
    with pytest.raises(RuntimeError):
        introspect.main(["latent-stats", "--ckpt", str(ckpt), "--data",
                         "d"])


def test_device_module_pins_float32():
    import globalegomocap_tpu_torch  # noqa: F401
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
