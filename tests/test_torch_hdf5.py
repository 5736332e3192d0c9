"""The port's window corpora beyond the AMASS pkls (`data/hdf5.py`,
`data/mo2cap2.py`) and the train CLI's --hdf5 / --hdf5_stream against the
JAX package's, on the JAX CLI tests' corpus (`synthetic_amass(12, 40,
seed=9)`, tests/test_cli_train.py) and JAX's Mo2Cap2 chunks
(tests/test_inventory_extras.py).

Tolerances: what the two packages compute in float32 SE(3) products (the
relative-global windows, the quaternion cameras) within 1e-6 absolute,
which is float32 rounding of 4 x 4 products of metre-scale poses; what
they only copy or read from a file (local windows, HDF5 datasets, the
stream's batches, `interpolate_frames`) exactly; a CLI run's eval within
5 %, the short-run tolerance of tests/test_torch_train.py, from the same
seed."""

import os
import pickle
import sys

import numpy as np
import pytest

import tests.torch_port_helpers  # noqa: F401  (one torch thread a worker)
import jax
from globalegomocap_tpu.cli import train as jcli
from globalegomocap_tpu.data import hdf5 as jh5
from globalegomocap_tpu.data.mo2cap2 import mo2cap2_windows as j_mo2cap2
from globalegomocap_tpu.data.synthetic import synthetic_amass, synthetic_chunk
from globalegomocap_tpu.train import train_vae as jtrain
from globalegomocap_tpu_torch.cli import train as tcli
from globalegomocap_tpu_torch.data import hdf5 as th5
from globalegomocap_tpu_torch.data.mo2cap2 import mo2cap2_windows
from globalegomocap_tpu_torch.models.convert import params_from_flax
from globalegomocap_tpu_torch.train import train_vae as ttrain
from tests.torch_port_helpers import hold_init, port_chunk

DATASETS = ("relative_global_pose", "local_pose", "camera_matrix")


@pytest.fixture(scope="module")
def amass_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("amass")
    for i, s in enumerate(synthetic_amass(n_sequences=12, frames_per_seq=40,
                                          seed=9)):
        with open(d / f"seq_{i:02d}.pkl", "wb") as f:
            pickle.dump(s, f)
    return str(d)


@pytest.fixture(scope="module")
def packed(amass_dir, tmp_path_factory):
    """The corpus packed by each package: {'jax': path, 'port': path}."""
    d = tmp_path_factory.mktemp("packed")
    out = {"jax": str(d / "jax.h5"), "port": str(d / "port.h5")}
    jh5.pack_amass_dir(amass_dir, out["jax"], frame_num=10)
    assert th5.pack_amass_dir(amass_dir, out["port"], frame_num=10) == \
        out["port"]
    return out


# ---------------------------------------------------------------------------
# Mo2Cap2 windows
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("local_pose", [False, True], ids=["rel", "local"])
@pytest.mark.parametrize("frames", [45, 30, 100])
def test_mo2cap2_windows_match_jax(frames, local_pose):
    """Every field of JAX's Mo2Cap2 windows: starts arange(0, n - 10, 10)
    (4 windows of 45 frames, 2 of 30, 9 of 100: the reference's loop
    leaves a last whole window out); poses within 1e-6 (relative-global)
    or exactly (local), cameras and ground truth exactly."""
    chunk = synthetic_chunk(frames, seed=frames)
    want = j_mo2cap2(chunk, frame_num=10, local_pose=local_pose)
    got = mo2cap2_windows(port_chunk(chunk), frame_num=10,
                          local_pose=local_pose)
    assert got.poses.shape == want.poses.shape == (
        len(range(0, frames - 10, 10)), 10, 45)
    for name in want._fields:
        a, b = getattr(got, name), np.asarray(getattr(want, name))
        assert a.dtype == b.dtype == np.float32, name
        if name == "poses" and not local_pose:
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
        else:
            np.testing.assert_array_equal(a, b, err_msg=name)
    if not local_pose:   # frame 0 of a relative-global window: the pose
        np.testing.assert_allclose(
            got.poses[0, 0], chunk.estimated_local[0].reshape(45), atol=1e-5)


# ---------------------------------------------------------------------------
# windows, files and streams
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("slide", [True, False], ids=["slide", "disjoint"])
@pytest.mark.parametrize("rate", [25, 50, 30])
def test_sequence_windows_with_cameras_match_jax(slide, rate):
    """(relative-global, local, cameras) of one sequence at 25, 50 and 30
    fps (strides 1, 2 and 1): the local windows exactly, the SE(3)
    products within 1e-6; a sequence too short for a window gives three
    empty arrays in both."""
    seq = synthetic_amass(n_sequences=1, frames_per_seq=60, frame_rate=rate,
                          seed=4)[0]
    want = jh5.sequence_windows_with_cameras(seq, 10, 25, slide)
    got = th5.sequence_windows_with_cameras(seq, 10, 25, slide)
    for a, b, exact in zip(got, want, (False, True, False)):
        b = np.asarray(b)
        assert a.shape == b.shape and a.dtype == b.dtype == np.float32
        if exact:
            np.testing.assert_array_equal(a, b)
        else:
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
    short = dict(seq, local_pose_list=seq["local_pose_list"][:10],
                 cam_list=seq["cam_list"][:10])
    for a, b in zip(th5.sequence_windows_with_cameras(short, 10, 25, slide),
                    jh5.sequence_windows_with_cameras(short, 10, 25, slide)):
        assert a.shape == np.asarray(b).shape and a.shape[0] == 0


def test_packed_files_cross_both_ways(packed):
    """Each package reads the other's file exactly as its writer's
    package reads it, in both modes of load_hdf5_windows; the two files
    hold the same datasets (local windows exactly, the SE(3) products
    within 1e-6)."""
    import h5py
    for path in packed.values():
        for local in (False, True):
            a = th5.load_hdf5_windows(path, local_pose=local).windows
            b = jh5.load_hdf5_windows(path, local_pose=local).windows
            assert a.shape == b.shape == (360, 10, 45)
            np.testing.assert_array_equal(a, b)
    with h5py.File(packed["jax"]) as fj, h5py.File(packed["port"]) as fp:
        assert sorted(fj) == sorted(fp) == sorted(DATASETS)
        for name in DATASETS:
            a, b = np.asarray(fp[name]), np.asarray(fj[name])
            assert a.shape == b.shape and a.dtype == b.dtype
            if name == "local_pose":
                np.testing.assert_array_equal(a, b)
            else:
                np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)


def test_store_appends_like_jax(tmp_path):
    """HDF5Store: two appends of each package give the same file."""
    import h5py
    rng = np.random.default_rng(0)
    parts = [rng.normal(size=(n, 3, 2)).astype(np.float32) for n in (4, 5)]
    for pkg, name in ((jh5, "j.h5"), (th5, "t.h5")):
        store = pkg.HDF5Store(str(tmp_path / name), {"x": (3, 2)})
        for p in parts:
            store.append({"x": p})
    with h5py.File(tmp_path / "j.h5") as fj, \
            h5py.File(tmp_path / "t.h5") as ft:
        assert ft["x"].maxshape == fj["x"].maxshape == (None, 3, 2)
        np.testing.assert_array_equal(ft["x"][()], fj["x"][()])


STREAMS = [dict(), dict(stop=-5), dict(start=-5), dict(start=3, stop=-40),
           dict(local_pose=True, start=-100)]


@pytest.mark.parametrize("kw", STREAMS,
                         ids=["all", "stop", "start", "both", "local"])
def test_stream_yields_jax_batches(packed, kw):
    """HDF5WindowStream at slab 7 over the JAX-packed file: for one seed,
    batch for batch JAX's batches (shuffled, drop_last and not; in
    order), the same length; every row a window of the file, each at most
    once an epoch."""
    path = packed["jax"]
    t = th5.HDF5WindowStream(path, slab_size=7, **kw)
    j = jh5.HDF5WindowStream(path, slab_size=7, **kw)
    assert len(t) == len(j) > 0
    bs = 16 if len(t) >= 32 else 2           # batches at start=-5 too
    for opts in (dict(), dict(drop_last=False), dict(shuffle=False),
                 dict(shuffle=False, drop_last=False)):
        rt, rj = np.random.default_rng(3), np.random.default_rng(3)
        bt = list(t.epoch_batches(rt, bs, **opts))
        bj = list(j.epoch_batches(rj, bs, **opts))
        assert len(bt) == len(bj) > 0, opts
        for a, b in zip(bt, bj):
            np.testing.assert_array_equal(a, b)
        assert rt.random() == rj.random()          # the same draws
    full = th5.load_hdf5_windows(path, kw.get("local_pose", False)).windows
    rows = {full[i].tobytes(): i for i in range(len(full))}
    seen = [rows[r.tobytes()] for r in np.concatenate(
        list(t.epoch_batches(np.random.default_rng(0), bs)))]
    assert len(set(seen)) == len(seen) == len(t) - len(t) % bs
    t.close(), j.close()
    t.close()                                      # twice is harmless


def test_stream_refuses_what_jax_refuses(packed, tmp_path):
    """A file that is not HDF5 (OSError naming the format) and a file
    without the dataset (KeyError naming the ones present)."""
    bad = tmp_path / "bad.h5"
    bad.write_bytes(b"not an hdf5 file")
    for pkg in (jh5, th5):
        with pytest.raises(OSError, match="pack_amass_dir format"):
            pkg.HDF5WindowStream(str(bad))
    store = th5.HDF5Store(str(tmp_path / "other.h5"), {"x": (2,)})
    for pkg in (jh5, th5):
        with pytest.raises(KeyError, match="datasets present"):
            pkg.HDF5WindowStream(store.path)


def test_without_h5py_the_port_packs_reads_and_streams(
        amass_dir, packed, tmp_path, monkeypatch, capsys):
    """With h5py blocked (`sys.modules['h5py'] = None`) the port packs the
    corpus, reads it whole, streams it and trains one epoch from it at
    --hdf5_stream true: its datasets are JAX's file's (local windows
    exactly, the SE(3) products within 1e-6), its reads JAX's reads of
    JAX's file, its stream JAX's batches from one seed, and the CLI run on
    its file the port's run on JAX's file, step for step."""
    import h5py
    with h5py.File(packed["jax"], "r") as f:
        datasets = {name: f[name][()] for name in f}
    want = {local: jh5.load_hdf5_windows(packed["jax"], local).windows
            for local in (False, True)}
    j = jh5.HDF5WindowStream(packed["jax"], local_pose=True, slab_size=7)
    batches = list(j.epoch_batches(np.random.default_rng(3), 16))
    j.close()
    monkeypatch.chdir(tmp_path)
    flags = ["--hdf5_stream", "true", "--local_pose", "true", "--device",
             "cpu"] + ARGS
    ref = tcli.main(["--train_data_path", packed["jax"], "--log_dir", "j"]
                    + flags)
    monkeypatch.setitem(sys.modules, "h5py", None)
    path = th5.pack_amass_dir(amass_dir, str(tmp_path / "port.h5"))
    with th5.h5file.open(path) as f:
        assert list(f) == sorted(DATASETS)
        for name, b in datasets.items():
            a = f[name].read()
            assert a.shape == b.shape and a.dtype == b.dtype
            np.testing.assert_allclose(a, b, rtol=0, atol=0 if name ==
                                       "local_pose" else 1e-6)
    for local, b in want.items():
        a = th5.load_hdf5_windows(path, local_pose=local).windows
        np.testing.assert_allclose(a, b, rtol=0, atol=0 if local else 1e-6)
    t = th5.HDF5WindowStream(path, local_pose=True, slab_size=7)
    got = list(t.epoch_batches(np.random.default_rng(3), 16))
    t.close()
    assert len(got) == len(batches) > 0
    assert all(np.array_equal(a, b) for a, b in zip(got, batches))
    run = tcli.main(["--train_data_path", path, "--log_dir", "t"] + flags)
    assert "train windows: 342, test windows: 18" in capsys.readouterr().out
    assert run.step == ref.step == 342 // 16
    assert run.history == ref.history
    assert sys.modules["h5py"] is None


@pytest.mark.parametrize("factor", [1, 2, 5])
def test_interpolate_frames_matches_jax(factor):
    seq = np.random.default_rng(factor).normal(size=(7, 15, 3))
    got = th5.interpolate_frames(seq, factor)
    assert got.shape == (6 * factor, 15, 3)
    np.testing.assert_array_equal(got, jh5.interpolate_frames(seq, factor))
    np.testing.assert_array_equal(got[::factor], seq[:-1])


# ---------------------------------------------------------------------------
# the train CLI on an HDF5 file
# ---------------------------------------------------------------------------

ARGS = ["--latent_dim", "16", "--seq_length", "10", "--kl_weight", "0.1",
        "--epoch", "1", "--batch_size", "16"]


@pytest.mark.parametrize("flags", [
    ["--hdf5", "true"], ["--hdf5", "true", "--local_pose", "true"],
    ["--hdf5_stream", "true"],
    ["--hdf5_stream", "true", "--epoch_scan", "true", "--log_step", "4"]],
    ids=["hdf5", "hdf5_local", "hdf5_stream", "hdf5_stream_scan"])
def test_cli_trains_on_hdf5_like_jax(packed, tmp_path, monkeypatch, capsys,
                                     flags):
    """Both train CLIs on the JAX-packed file from the same seed, the
    port's starting from the JAX trainer's initial weights (within 1e-6
    of each leaf's largest magnitude) and drawing its noise: the same
    windows line (the
    last max(1, n // 20) windows for test), the same step count, the same
    history keys and steps, the eval within 5 %, checkpoints from both;
    a stream records no motion statistic, as in JAX.  With --epoch_scan
    the stream is consumed in the same blocks."""
    monkeypatch.chdir(tmp_path)
    made = []
    jinit = jtrain.Trainer.__init__

    def record(self, *a, **k):
        jinit(self, *a, **k)
        made.append(jax.tree_util.tree_map(np.asarray, jax.device_get(
            self.variables)))
    monkeypatch.setattr(jtrain.Trainer, "__init__", record)
    jt = jcli.main(["--train_data_path", packed["jax"], "--log_dir", "j"]
                   + ARGS + flags)
    jout = capsys.readouterr().out
    tinit = ttrain.Trainer.__init__

    def seeded(self, *a, **k):
        tinit(self, *a, **k)
        hold_init(self.model.state_dict(), params_from_flax(made[0]))
    monkeypatch.setattr(ttrain.Trainer, "__init__", seeded)
    tt = tcli.main(["--train_data_path", packed["jax"], "--log_dir", "t",
                    "--device", "cpu"] + ARGS + flags)
    tout = capsys.readouterr().out
    line = "train windows: 342, test windows: 18"
    assert line in jout and line in tout
    assert tt.step == int(jt.state.step) == 342 // 16
    assert [sorted(h) for h in tt.history] == [sorted(h) for h in jt.history]
    assert [h.get("step") for h in tt.history] == \
        [h.get("step") for h in jt.history]
    je, te = jt.history[-1]["eval_mpjpe"], tt.history[-1]["eval_mpjpe"]
    assert abs(te - je) <= 0.05 * je, (te, je)
    stream = "--hdf5_stream" in flags
    assert (tt.motion_stats is None) == (jt.motion_stats is None) == stream
    for d in ("j", "t"):
        assert sorted(os.listdir(tmp_path / "logs" / d / "checkpoints")) \
            == ["0.json", "0.msgpack"]
