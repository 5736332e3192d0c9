"""The port's AMASS training data against the JAX package's: windows,
the pkl loader's split and filters, the epoch batch order, the synthetic
corpus, the motion-regime statistic the trainer records, and the
quaternion transforms the relative-global windows run through.

Local-pose windows are gathers and equal bit for bit; relative-global
windows go through a float32 SE(3) product and agree within 1e-5."""

import pickle

import numpy as np
import pytest
import jax.numpy as jnp

import tests.torch_port_helpers  # noqa: F401  (one torch thread a worker)
import torch
from globalegomocap_tpu.data import amass as jamass
from globalegomocap_tpu.data.synthetic import synthetic_amass as jsynth
from globalegomocap_tpu.ops import transforms as jtf
from globalegomocap_tpu.optimize import prior_bank as jbank
from globalegomocap_tpu_torch.data import amass as tamass
from globalegomocap_tpu_torch.data.synthetic import synthetic_amass as tsynth
from globalegomocap_tpu_torch.ops import transforms as ttf
from globalegomocap_tpu_torch.optimize import prior_bank as tbank


@pytest.fixture(scope="module")
def amass_data():
    return jsynth(n_sequences=3, frames_per_seq=80, seed=1)


def _fps50(data):
    out = [dict(d) for d in data]
    out[0]["frame_rate"] = 50
    return out


WINDOW_CASES = {
    "default": (lambda d: d, {}),
    "fps50": (_fps50, {}),
    "dilation2": (lambda d: d, {"dilation": 2}),
    "disjoint": (lambda d: d, {"slide_window": False}),
    "frames5": (lambda d: d, {"frame_num": 5}),
}


@pytest.mark.parametrize("case", sorted(WINDOW_CASES))
@pytest.mark.parametrize("local_pose", [True, False],
                         ids=["local", "relative_global"])
def test_window_sequences_match_jax(amass_data, case, local_pose):
    fix, kw = WINDOW_CASES[case]
    data = fix(amass_data)
    kw = dict(kw, local_pose=local_pose)
    j = jamass.window_sequences(data, **kw)
    t = tamass.window_sequences(data, **kw)
    assert t.dtype == np.float32 and t.shape == j.shape and len(t) > 0
    if local_pose:
        np.testing.assert_array_equal(t, j)
    else:
        np.testing.assert_allclose(t, j, rtol=0, atol=1e-5)


def test_window_sequences_of_too_short_sequences_are_empty(amass_data):
    t = tamass.window_sequences(amass_data, frame_num=100)
    assert t.shape == jamass.window_sequences(amass_data,
                                              frame_num=100).shape
    assert t.shape == (0, 100, 45)


@pytest.fixture(scope="module")
def pkl_dir(tmp_path_factory, amass_data):
    """24 files, half of them walk-*, two of them named for mo2cap2."""
    d = tmp_path_factory.mktemp("amass_pkls")
    for i in range(24):
        name = f"{'walk' if i % 2 else 'run'}_{i:02d}"
        if i in (3, 20):
            name += "_mo2cap2seq"
        with open(d / f"{name}.pkl", "wb") as f:
            pickle.dump(amass_data[i % len(amass_data)], f)
    return str(d)


LOAD_CASES = {
    "train": dict(is_train=True),
    "test": dict(is_train=False),
    "train_balanced": dict(is_train=True, balance_walking=True),
    "test_balanced": dict(is_train=False, balance_walking=True),
    "balanced_seed7": dict(is_train=True, balance_walking=True, seed=7),
    "mo2cap2": dict(is_train=False, mo2cap2_names=["mo2cap2seq", "run_1"]),
}


@pytest.mark.parametrize("case", sorted(LOAD_CASES))
def test_load_amass_pkls_matches_jax(pkl_dir, case):
    """The 10-file test split, walking balance through
    default_rng(seed), the mo2cap2 name filter: the same files in the
    same order."""
    j = jamass.load_amass_pkls(pkl_dir, **LOAD_CASES[case])
    t = tamass.load_amass_pkls(pkl_dir, **LOAD_CASES[case])
    assert len(t) == len(j)
    for a, b in zip(t, j):
        np.testing.assert_array_equal(a["local_pose_list"],
                                      b["local_pose_list"])
        assert a["frame_rate"] == b["frame_rate"]


@pytest.mark.parametrize("local_pose", [True, False],
                         ids=["local", "relative_global"])
def test_from_dir_matches_jax(pkl_dir, local_pose):
    kw = dict(frame_num=10, fps=25, is_train=True, local_pose=local_pose,
              balance_walking=True, dilation=2)
    j = jamass.AmassWindows.from_dir(pkl_dir, **kw)
    t = tamass.AmassWindows.from_dir(pkl_dir, **kw)
    assert len(t) == len(j) > 0
    np.testing.assert_allclose(t.windows, j.windows, rtol=0,
                               atol=0 if local_pose else 1e-5)


@pytest.mark.parametrize("kw", [
    {}, {"drop_last": False}, {"shuffle": False},
    {"drop_last": False, "shuffle": False}],
    ids=["shuffled", "keep_last", "in_order", "in_order_keep_last"])
def test_epoch_batches_order_matches_jax(amass_data, kw):
    """The same numpy generator gives the same batches in the same order,
    epoch after epoch."""
    j = jamass.AmassWindows.from_sequences(amass_data, local_pose=True)
    t = tamass.AmassWindows.from_sequences(amass_data, local_pose=True)
    rj, rt = np.random.default_rng(2), np.random.default_rng(2)
    for _ in range(2):
        bj = list(j.epoch_batches(rj, 32, **kw))
        bt = list(t.epoch_batches(rt, 32, **kw))
        assert len(bt) == len(bj) > 0
        for a, b in zip(bt, bj):
            np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def cli_corpus():
    """The JAX train CLI test's corpus, from both packages."""
    return (jsynth(n_sequences=12, frames_per_seq=40, seed=9),
            tsynth(n_sequences=12, frames_per_seq=40, seed=9))


def test_synthetic_amass_matches_jax(cli_corpus):
    j, t = cli_corpus
    assert len(t) == len(j) == 12
    for a, b in zip(t, j):
        assert a["local_pose_list"].dtype == np.float32
        np.testing.assert_array_equal(a["local_pose_list"],
                                      b["local_pose_list"])
        assert a["frame_rate"] == b["frame_rate"]
        assert len(a["cam_list"]) == len(b["cam_list"]) == 40
        for ca, cb in zip(a["cam_list"], b["cam_list"]):
            np.testing.assert_allclose(ca["loc"], cb["loc"], rtol=0,
                                       atol=1e-6)
            np.testing.assert_allclose(ca["rot"], cb["rot"], rtol=0,
                                       atol=1e-6)


@pytest.mark.parametrize("local_pose", [True, False],
                         ids=["local", "relative_global"])
def test_windows_accel_stat_matches_jax(cli_corpus, local_pose):
    j, t = cli_corpus
    wj = jamass.window_sequences(j, local_pose=local_pose)
    wt = tamass.window_sequences(t, local_pose=local_pose)
    a, b = tbank.windows_accel_stat(wt), jbank.windows_accel_stat(wj)
    assert np.isfinite(a) and a > 0
    assert a == pytest.approx(b, rel=1e-6)
    assert np.isnan(tbank.windows_accel_stat(wt[:0]))


@pytest.mark.parametrize("window", [None, 10, 16])
def test_motion_accel_stat_matches_jax(cli_corpus, window):
    pose = np.stack([s["local_pose_list"] for s in cli_corpus[1]])
    a = tbank.motion_accel_stat(pose, window=window)
    b = jbank.motion_accel_stat(pose, window=window)
    assert a == pytest.approx(b, rel=1e-6)


def test_quaternion_transforms_match_jax():
    rng = np.random.default_rng(0)
    quat = rng.normal(size=(64, 4)).astype(np.float32) * 3
    trans = rng.normal(size=(64, 3)).astype(np.float32)
    r = ttf.quat_to_rotmat(torch.from_numpy(quat)).numpy()
    np.testing.assert_allclose(
        r, np.asarray(jtf.quat_to_rotmat(jnp.asarray(quat))), atol=1e-6)
    m = ttf.quat_trans_to_matrix(torch.from_numpy(trans),
                                 torch.from_numpy(quat)).numpy()
    np.testing.assert_allclose(m, np.asarray(jtf.quat_trans_to_matrix(
        jnp.asarray(trans), jnp.asarray(quat))), atol=1e-6)
    from scipy.spatial.transform import Rotation
    np.testing.assert_allclose(r, Rotation.from_quat(quat).as_matrix(),
                               atol=1e-5)
