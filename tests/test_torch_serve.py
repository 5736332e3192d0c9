"""The port's serve CLI in one-shot mode on a temporary data root with
--device cpu: one JSON line per sequence with the JAX serve's keys, and
the same answers as the JAX serve at float32 compute on the same priors
(metrics within 5 %, the precedent of test_fused_energy.py:297-308)."""

import json

import numpy as np
import pytest
import torch

from globalegomocap_tpu.cli import serve as jserve
from globalegomocap_tpu.data.test_data import save_test_chunk
from globalegomocap_tpu.models.checkpoint import save_msgpack
from globalegomocap_tpu.optimize import driver as jdriver
from globalegomocap_tpu_torch.cli import serve as tserve
from tests.torch_port_helpers import (
    chunks, jax_variables, jcfg, port_state, slice_config)

JAX_KEYS = {"sequence", "chunks", "windows", "latency_ms",
            "windows_per_sec", "optimized_global_mpjpe",
            "original_global_mpjpe"}
PRIOR = ["--latent_dim", "32", "--hidden_dims", "8,8,16,16,32"]


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("serve")
    root = tmp / "incoming"
    for s, seeds in (("seqA", (1, 2)), ("seqB", (3,))):
        for j, c in enumerate(chunks(26, seeds)):
            save_test_chunk(c, str(root / s / f"data_start_{26 * j}_end_"
                                                f"{26 * (j + 1)}"))
    v = jax_variables(jdriver.build_model(slice_config(jcfg)), seed=0)
    save_msgpack(v, str(tmp / "prior.msgpack"))
    torch.save(port_state(v), tmp / "prior.pt")
    return root, tmp


def _lines(capsys):
    return [json.loads(x) for x in capsys.readouterr().out.splitlines()
            if x.startswith("{")]


def test_serve_matches_jax_serve(served, capsys):
    root, tmp = served
    ck = str(tmp / "prior.pt")
    n = tserve.main(["--data_root", str(root), "--local_ckpt", ck,
                     "--global_ckpt", ck, "--device", "cpu",
                     "--save_pose", "true", "--out_dir",
                     str(tmp / "out")] + PRIOR)
    port = {r["sequence"]: r for r in _lines(capsys)}
    assert n == 2 and set(port) == {"seqA", "seqB"}
    for rec in port.values():
        assert set(rec) == JAX_KEYS
    assert (port["seqA"]["chunks"], port["seqA"]["windows"]) == (2, 6)
    assert (port["seqB"]["chunks"], port["seqB"]["windows"]) == (1, 3)
    assert np.load(tmp / "out" / "seqA" / "optimized.npy").shape == (
        2, 26, 15, 3)

    jck = str(tmp / "prior.msgpack")
    jserve.main(["--data_root", str(root), "--local_ckpt", jck,
                 "--global_ckpt", jck, "--compute_dtype", "float32",
                 "--unroll", "1", "--prefetch_depth", "0"] + PRIOR)
    ref = {r["sequence"]: r for r in _lines(capsys)}
    for name, rec in port.items():
        assert set(rec) == set(ref[name])
        assert (rec["chunks"], rec["windows"]) == (ref[name]["chunks"],
                                                   ref[name]["windows"])
        for key in ("optimized_global_mpjpe", "original_global_mpjpe"):
            assert abs(rec[key] - ref[name][key]) <= 0.05 * ref[name][key]


@pytest.mark.parametrize("flag,value,name", [
    ("--compute_dtype", "bfloat16_delta", "compute_dtype"),
    ("--watch_interval", "2.0", "watch_interval"),
    ("--prefetch_depth", "2", "prefetch_depth"),
    ("--stage_on_host", "false", "stage_on_host")])
def test_serve_rejects_options_of_later_slices(served, flag, value, name):
    root, tmp = served
    ck = str(tmp / "prior.pt")
    with pytest.raises(NotImplementedError, match=name):
        tserve.main(["--data_root", str(root), "--local_ckpt", ck,
                     "--global_ckpt", ck, "--device", "cpu", flag, value]
                    + PRIOR)
