"""The port stands alone: importing every module of
`globalegomocap_tpu_torch` loads neither `jax` nor anything of the JAX
package, and its entry points run on the card unless told otherwise."""

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
import importlib, json, pkgutil, sys
import globalegomocap_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__,
                                               pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
from globalegomocap_tpu_torch.optimize.lbfgs import (  # noqa: F401
    adam_minimize, lbfgs_minimize)
from globalegomocap_tpu_torch.native.hostcrop import (  # noqa: F401
    crop_peak_native)
bad = [m for m in sys.modules
       if m == "jax" or m.startswith("jax.")
       or m == "globalegomocap_tpu" or m.startswith("globalegomocap_tpu.")]
print(json.dumps({"modules": names, "bad": bad}))
"""


def test_port_imports_no_jax():
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300,
                         check=True)
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    assert rec["bad"] == []
    for mod in ("cli.serve", "cli.optimize_sequence", "ops.cuda_build",
                "ops.fused_energy", "ops.fused_decode_energy",
                "ops.heatmap_sample",
                "ops.lbfgs_direction", "ops.sampling", "optimize.driver",
                "optimize.pipeline", "optimize.lbfgs", "models.convert",
                "data.synthetic", "native.hostcrop"):
        assert "globalegomocap_tpu_torch." + mod in rec["modules"]


def test_entry_points_need_a_card_unless_cpu(monkeypatch, tmp_path):
    from globalegomocap_tpu_torch.cli import optimize_sequence, serve
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


def test_device_module_pins_float32():
    import globalegomocap_tpu_torch  # noqa: F401
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
