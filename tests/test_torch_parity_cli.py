"""The port's parity CLI (`cli/optimize_sequence.py`) at its own defaults,
with no --solver flag (strong-Wolfe L-BFGS), on priors written as the
reference's .pth.tar training checkpoints ({'epoch', 'args',
'state_dict', 'eval_result', 'optimizer'}, with an argparse.Namespace
under 'args') from the JAX package's own `flax_to_torch_state_dict`:
the 17-metric summary, within 5 % of the JAX CLI's on the same files.
Also the checkpoint loader (`cli/serve.py::load_state`): a training
checkpoint and a bare state dict give the same weights, and a file whose
keys or shapes are not the prior's, or that pickles another object,
raises."""

import argparse
import collections
import pickle

import numpy as np
import pytest
import torch

from globalegomocap_tpu.cli import optimize_sequence as jcli
from globalegomocap_tpu.data.test_data import save_test_chunk
from globalegomocap_tpu.evaluation.metrics import METRIC_KEYS
from globalegomocap_tpu.models.torch_convert import flax_to_torch_state_dict
from globalegomocap_tpu.optimize import driver as jdriver
from globalegomocap_tpu_torch.cli import optimize_sequence as tcli
from globalegomocap_tpu_torch.cli.serve import load_state
from globalegomocap_tpu_torch.optimize import driver as tdriver
from tests.torch_port_helpers import (
    TINY_PRIOR, chunks, jax_variables, jcfg, slice_config, tcfg)

PRIOR = ["--latent_dim", "32", "--hidden_dims", "8,8,16,16,32"]


def _training_checkpoint(state: dict) -> dict:
    """A state dict wrapped as the reference's trainer saves it."""
    return {"epoch": 7,
            "args": argparse.Namespace(latent_dim=32, seq_len=10, lr=1e-4,
                                       batch_size=64, data="amass"),
            "state_dict": state,
            "eval_result": 0.0731,
            "optimizer": {"state": {}, "param_groups": [
                {"lr": 1e-4, "betas": (0.9, 0.999), "params": [0, 1]}]}}


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    v = jax_variables(jdriver.build_model(slice_config(jcfg)), seed=0)
    state = {k: torch.from_numpy(np.array(a)) for k, a in
             flax_to_torch_state_dict(v, TINY_PRIOR["seq_len"],
                                      TINY_PRIOR["hidden_dims"]).items()}
    tmp = tmp_path_factory.mktemp("parity_cli")
    for j, c in enumerate(chunks(26, (1, 2))):
        save_test_chunk(c, str(tmp / "seqA" /
                               f"data_start_{26 * j}_end_{26 * (j + 1)}"))
    torch.save(_training_checkpoint(state), tmp / "prior.pth.tar")
    torch.save(state, tmp / "prior.pt")
    return tmp, state


def test_cli_runs_at_its_defaults_and_matches_jax(files, capsys):
    tmp, _ = files
    ckpt = str(tmp / "prior.pth.tar")
    argv = ["--data_path", str(tmp / "seqA"), "--local_ckpt", ckpt,
            "--global_ckpt", ckpt] + PRIOR
    tavg = tcli.main(argv + ["--device", "cpu", "--sampling", "pallas"])
    out = capsys.readouterr().out
    assert out.count("Average ") == 16 and "joints error is:" in out
    assert "total optimization time" in out and "SKIPPED" not in out
    javg = jcli.main(argv + ["--sampling", "dense"])
    for key in METRIC_KEYS[:17]:
        a, b = float(tavg[key]), float(javg[key])
        assert abs(a - b) <= 0.05 * abs(b), (key, a, b)


def test_training_checkpoint_and_bare_state_dict_load_alike(files):
    tmp, state = files
    model = tdriver.build_model(slice_config(tcfg))
    for name in ("prior.pth.tar", "prior.pt"):
        got = load_state(str(tmp / name), model)
        assert set(got) == set(state)
        for k, v in state.items():
            assert torch.equal(got[k], v), (name, k)


class _NotAWeight:
    pass


@pytest.mark.parametrize("change,error,match", [
    ("rename", ValueError, "unexpected"),
    ("drop", ValueError, "missing"),
    ("reshape", ValueError, "mis-shaped"),
    ("pickle", pickle.UnpicklingError, "_NotAWeight")])
def test_a_checkpoint_that_is_not_the_prior_raises(files, tmp_path, change,
                                                   error, match):
    _, state = files
    state = collections.OrderedDict(state)
    if change == "rename":
        state["decoder.9.0.weight"] = state.pop("decoder.0.0.weight")
    elif change == "drop":
        del state["fc_mu.bias"]
    elif change == "reshape":
        state["fc_mu.bias"] = torch.zeros(33)
    blob = _training_checkpoint(state)
    if change == "pickle":
        blob["eval_result"] = _NotAWeight()
    path = tmp_path / "bad.pth.tar"
    torch.save(blob, path)
    model = tdriver.build_model(slice_config(tcfg))
    with pytest.raises(error, match=match):
        load_state(str(path), model)
    if change != "pickle":
        with pytest.raises(ValueError, match=match):
            tcli.main(["--data_path", str(files[0] / "seqA"),
                       "--local_ckpt", str(path), "--global_ckpt",
                       str(path), "--device", "cpu"] + PRIOR)
