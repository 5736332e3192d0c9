"""The port's train CLI (`cli/train.py`) on the CPU: the JAX train CLI
test's run (tests/test_cli_train.py) with --device cpu, --resume, the
parser against the JAX package's flag for flag, the ranks --num_devices
asks for (tests/test_torch_dp_train.py trains on two), and the card it
asks for by default."""

import os
import pickle

import numpy as np
import pytest

import tests.torch_port_helpers  # noqa: F401  (one torch thread a worker)
import torch
from globalegomocap_tpu.cli import train as jcli
from globalegomocap_tpu_torch.cli import train as tcli
from globalegomocap_tpu_torch.data.synthetic import synthetic_amass

ARGS = ["--latent_dim", "16", "--seq_length", "10", "--kl_weight", "0.1",
        "--epoch", "1", "--batch_size", "16", "--local_pose", "true"]


@pytest.fixture(scope="module")
def amass_dir(tmp_path_factory):
    """The JAX CLI test's corpus, made by the port."""
    d = tmp_path_factory.mktemp("amass")
    for i, s in enumerate(synthetic_amass(n_sequences=12, frames_per_seq=40,
                                          seed=9)):
        with open(d / f"seq_{i:02d}.pkl", "wb") as f:
            pickle.dump(s, f)
    return str(d)


def test_train_cli_writes_epoch_checkpoints_and_resumes(
        amass_dir, tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    trainer = tcli.main(["--train_data_path", amass_dir, "--log_dir", "t1",
                         "--device", "cpu"] + ARGS)
    out = capsys.readouterr().out
    # 2 train files of 40 frames (30 windows each), 10 test files
    assert "train windows: 60, test windows: 300" in out
    assert "epoch 0: eval reconstruction MPJPE" in out
    assert np.isfinite(trainer.evaluate())
    ckpts = tmp_path / "logs" / "t1" / "checkpoints"
    assert sorted(os.listdir(ckpts)) == ["0.json", "0.msgpack"]
    assert trainer.step == 3
    resumed = tcli.main(["--train_data_path", amass_dir, "--log_dir", "t2",
                         "--device", "cpu", "--resume",
                         str(ckpts / "0.msgpack")] + ARGS)
    assert resumed.step == 2 * trainer.step


def _flags(parser):
    return {a.dest: (tuple(a.option_strings), a.default,
                     getattr(a.type, "__name__", a.type),
                     tuple(a.choices or ()), a.required)
            for a in parser._actions if a.dest != "help"}


def test_parser_has_the_jax_flags_and_defaults():
    j, t = _flags(jcli.build_parser()), _flags(tcli.build_parser())
    assert set(t) == set(j) | {"device"}
    for dest, spec in j.items():
        assert t[dest] == spec, dest
    assert t["device"][1] == "cuda"


def test_more_ranks_than_cards_raise(amass_dir, tmp_path, monkeypatch):
    """--num_devices above the visible cards raises ValueError naming
    both counts, before any data is read or any file written."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match=r"--num_devices 2 .* the 1 "
                                         r"visible card"):
        tcli.main(["--train_data_path", amass_dir, "--num_devices", "2"]
                  + ARGS)
    assert not os.path.exists(tmp_path / "logs")


@pytest.mark.parametrize("source", [
    ["--hdf5", "true"], ["--hdf5_stream", "true"], []],
    ids=["hdf5", "hdf5_stream", "orbax"])
def test_orbax_epoch_checkpoints_resume_in_both_clis(
        amass_dir, tmp_path, monkeypatch, source):
    """One epoch at --checkpoint_format orbax from each data source (the
    corpus packed into HDF5 and read whole or streamed, held on the CPU
    only as h5py is missing on the card's machine; the pkl directory):
    <epoch>.orbax and <epoch>.json, and the port's and JAX's train CLIs
    --resume from the directory, one more epoch of steps each."""
    monkeypatch.chdir(tmp_path)
    data = amass_dir
    if source:
        from globalegomocap_tpu_torch.data.hdf5 import pack_amass_dir
        data = pack_amass_dir(amass_dir, str(tmp_path / "corpus.h5"),
                              frame_num=10)
    common = ["--train_data_path", data] + ARGS + source
    first = tcli.main(common + ["--log_dir", "o", "--device", "cpu",
                                "--checkpoint_format", "orbax"])
    ckpts = tmp_path / "logs" / "o" / "checkpoints"
    assert sorted(os.listdir(ckpts)) == ["0.json", "0.orbax"]
    assert first.step == (342 if source else 60) // 16
    ckpt = str(ckpts / "0.orbax")
    port = tcli.main(common + ["--log_dir", "p", "--device", "cpu",
                               "--resume", ckpt])
    jax_run = jcli.main(common + ["--log_dir", "j", "--resume", ckpt])
    assert port.step == int(jax_run.state.step) == 2 * first.step


@pytest.mark.parametrize("cards", [1, 3])
def test_zero_means_every_visible_card(cards, monkeypatch):
    """--num_devices 0 (the default) asks for a rank a visible card, so
    one process where one card is visible; on the CPU it is one rank,
    and N is N ranks there."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    assert tcli.build_parser().get_default("num_devices") == 0
    assert tcli.ranks_for(0, cuda) == cards
    assert tcli.ranks_for(1, cuda) == 1
    assert tcli.ranks_for(0, cpu) == 1 and tcli.ranks_for(4, cpu) == 4


def test_the_cli_asks_for_the_card_by_default(amass_dir, tmp_path,
                                              monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tcli.main(["--train_data_path", amass_dir] + ARGS)
    assert not os.path.exists(tmp_path / "logs")


def test_mo2cap2_names_restrict_the_corpus(amass_dir, tmp_path, monkeypatch,
                                           capsys):
    """--with_mo2cap2_names from a text file (one name a line) and an npy
    file: the same filter as the JAX loader."""
    monkeypatch.chdir(tmp_path)
    names = [f"seq_{i:02d}" for i in range(11)]
    (tmp_path / "names.txt").write_text("\n".join(names) + "\n")
    np.save(tmp_path / "names.npy", np.asarray(names, dtype=object))
    assert tcli.load_mo2cap2_names(str(tmp_path / "names.txt")) == \
        jcli.load_mo2cap2_names(str(tmp_path / "names.txt")) == names
    assert tcli.load_mo2cap2_names(str(tmp_path / "names.npy")) == names
    tcli.main(["--train_data_path", amass_dir, "--device", "cpu",
               "--with_mo2cap2_names", str(tmp_path / "names.txt"),
               "--log_dir", "m"] + ARGS)
    assert "train windows: 30, test windows: 300" in capsys.readouterr().out
