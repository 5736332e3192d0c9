"""The port's Orbax checkpoints (`native/zstd.py`, `models/ocdbt.py`,
`models/orbax.py`, the Orbax branches of `models/checkpoint.py` and of
the trainer) against the JAX package's orbax 0.11 on the CPU.

Every comparison of leaves is bit for bit: `np.testing.assert_array_equal`
with the dtype and shape checked, and the tree's structure (dict keys,
list lengths, None) equal.  Evals of a resumed trainer are held at the
1e-5 relative of tests/test_torch_train.py's msgpack cross-resume.  The
trainer cases run on that file's tiny trainer (latent 32, hidden 16, 16,
32, 32, 64); the prior cases on tests/test_golden.py's tiny prior
(latent 32, hidden 8, 8, 16, 16, 32); the fixture is
tests/torch_fixtures/orbax_jax/ (latent 16)."""

import json
import os
import struct
import sys

import google_crc32c
import jax
import jax.numpy as jnp
import numpy as np
import orbax.checkpoint as ocp
import pytest
import zstandard
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from tests.test_torch_train import (  # noqa: F401  (data is a fixture)
    OPTIMIZERS, _moments_equal, _np, data, jax_trainer, port_trainer)
from tests.torch_port_helpers import jax_variables
from globalegomocap_tpu.models import checkpoint as jck
from globalegomocap_tpu.models import conv_vae as jvae
from globalegomocap_tpu_torch.models import checkpoint as tck
from globalegomocap_tpu_torch.models import ocdbt
from globalegomocap_tpu_torch.models import orbax as tob
from globalegomocap_tpu_torch.models.convert import params_to_flax
from globalegomocap_tpu_torch.native import zstd

HIDDEN = (8, 8, 16, 16, 32)
FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "torch_fixtures", "orbax_jax")


def assert_tree_equal(got, want, path="tree"):
    """The same structure (dict keys, list lengths, None) and leaves equal
    bit for bit, with the same dtype and shape."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want), \
            (path, got if not isinstance(got, dict) else sorted(got),
             sorted(want))
        for k in want:
            assert_tree_equal(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, (list, tuple)):
        assert isinstance(got, (list, tuple)) and len(got) == len(want), \
            (path, got, want)
        for i, (a, b) in enumerate(zip(got, want)):
            assert_tree_equal(a, b, f"{path}/{i}")
    elif want is None:
        assert got is None, (path, got)
    else:
        a, b = np.asarray(got), np.asarray(want)
        assert (a.dtype, a.shape) == (b.dtype, b.shape), (path, a.dtype,
                                                          a.shape, b.dtype,
                                                          b.shape)
        np.testing.assert_array_equal(a, b, err_msg=path)


def jax_restored(tree):
    """JAX's restored tree with jax.Array leaves as numpy."""
    return jax.tree_util.tree_map(
        lambda x: np.asarray(x) if isinstance(x, jax.Array) else x, tree)


@pytest.fixture(scope="module")
def prior():
    """The tiny prior's variables (numpy leaves, random BN statistics)."""
    model = jvae.ConvVAE(latent_dim=32, seq_len=10, hidden_dims=HIDDEN)
    return _np(jax_variables(model, seed=5))


# ---------------------------------------------------------------------------
# the building blocks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("data_,crc", [
    (b"123456789", 0xE3069283), (b"", 0), (bytes(32), 0x8A9136AA),
    (b"\xff" * 32, 0x62A8AB43), (bytes(range(32)), 0x46DD794E)],
    ids=["check", "empty", "zeros", "ones", "incrementing"])
def test_crc32c_known_vectors(data_, crc):
    """RFC 3720's CRC-32C test vectors and the check value, exactly."""
    assert ocdbt.crc32c(data_) == crc


def test_crc32c_matches_google_crc32c():
    raw = np.random.default_rng(0).integers(0, 256, 4099, np.uint8)
    assert ocdbt.crc32c(raw.tobytes()) == google_crc32c.value(raw.tobytes())
    assert ocdbt.crc32c(raw[2000:].tobytes(),
                        ocdbt.crc32c(raw[:2000].tobytes())) == \
        google_crc32c.value(raw.tobytes())


def test_zstd_frames_with_and_without_content_size():
    """libzstd through ctypes on frames that state their size (its own,
    `zstandard`'s) and on ones that do not (zarr's, frame header
    descriptor 0x00): the same bytes out, exactly."""
    a = np.random.default_rng(1).standard_normal(3000).astype(np.float32)
    a[:1000] = 0                        # something to compress
    raw = a.tobytes()
    own = zstd.compress(a, 1)
    sized = zstandard.ZstdCompressor(level=1).compress(raw)
    unsized = zstandard.ZstdCompressor(
        level=1, write_content_size=False).compress(raw)
    assert unsized[4] == 0x00 and len(own) < len(raw)
    assert zstandard.ZstdDecompressor().decompress(bytes(own)) == raw
    assert zstd.content_size(own) == zstd.content_size(sized) == len(raw)
    assert zstd.content_size(unsized) is None
    for frame in (own, sized, unsized):
        assert zstd.decompress(frame) == raw
        out = np.empty_like(a)
        zstd.decompress_into(frame, out)
        np.testing.assert_array_equal(out, a)
    with pytest.raises(ValueError, match="zstd"):
        zstd.decompress_into(unsized, np.empty(10, np.float32))
    with pytest.raises(ValueError, match="zstd"):
        zstd.content_size(b"not a zstd frame")


def test_missing_library_raises_naming_it(monkeypatch):
    monkeypatch.setattr(zstd, "_lib", None)
    monkeypatch.setattr(zstd, "LIBRARY", "libzstd_missing.so.1")
    with pytest.raises(RuntimeError, match="libzstd_missing.so.1"):
        zstd.compress(b"x")


# ---------------------------------------------------------------------------
# priors, both ways
# ---------------------------------------------------------------------------

def test_jax_save_orbax_reads_in_the_port(prior, tmp_path):
    """JAX save_orbax -> the port's load_orbax and load_prior_variables:
    JAX's trees, bit for bit."""
    path = str(tmp_path / "prior.orbax")
    jck.save_orbax(prior, path)
    assert os.path.isdir(os.path.join(path, "ocdbt.process_0"))
    assert_tree_equal(tck.load_orbax(path), jax_restored(jck.load_orbax(path)))
    assert_tree_equal(tck.load_prior_variables(path, 10, HIDDEN),
                      _np(jck.load_prior_variables(path, 10, HIDDEN)))


def test_port_save_orbax_reads_in_jax(prior, tmp_path):
    """The port's save_orbax -> JAX's load_orbax, restore with a target,
    and load_prior_variables: the saved leaves, bit for bit.  The
    directory has JAX's files; a second save to it raises as orbax's
    does."""
    path = str(tmp_path / "prior.orbax")
    tck.save_orbax(prior, path)
    assert sorted(os.listdir(path)) == ["_CHECKPOINT_METADATA", "_METADATA",
                                        "d", "manifest.ocdbt"]
    assert_tree_equal(jax_restored(jck.load_orbax(path)), prior)
    target = jax.tree_util.tree_map(np.zeros_like, prior)
    assert_tree_equal(jax_restored(ocp.StandardCheckpointer().restore(
        path, target=target)), prior)
    assert_tree_equal(_np(jck.load_prior_variables(path, 10, HIDDEN)),
                      prior)
    assert_tree_equal(tck.load_prior_variables(path, 10, HIDDEN), prior)
    with pytest.raises(ValueError, match="already exists"):
        tck.save_orbax(prior, path)
    with pytest.raises(ValueError, match="hidden dims"):
        tck.load_prior_variables(path, 10, (8, 8, 16, 16, 64))


def test_jax_array_leaves_read_in_the_port(tmp_path):
    """A tree of jax.Array leaves (orbax adds `_sharding` and
    `array_metadatas/`) reads as numpy."""
    tree = {"w": jnp.arange(12, dtype=jnp.float32).reshape(3, 4),
            "n": {"c": jnp.asarray(7, jnp.int32)}}
    path = str(tmp_path / "j.orbax")
    ckptr = ocp.StandardCheckpointer()
    ckptr.save(path, tree)
    ckptr.wait_until_finished()
    assert os.path.exists(os.path.join(path, "_sharding"))
    assert os.path.isdir(os.path.join(path, "array_metadatas"))
    meta = json.load(open(os.path.join(path, "_METADATA")))
    assert {v["value_metadata"]["value_type"]
            for v in meta["tree_metadata"].values()} == {"jax.Array"}
    assert_tree_equal(tob.load(path), jax_restored(ckptr.restore(path)))


def test_several_chunks_per_array(tmp_path):
    """SaveArgs(chunk_byte_size) splits arrays into chunks, edge chunks
    partly outside the array; the port reads them whole."""
    rng = np.random.default_rng(2)
    tree = {"a": rng.standard_normal(300).astype(np.float32),
            "b": rng.standard_normal((37, 50)).astype(np.float32),
            "c": rng.integers(0, 9, (7, 3, 5)).astype(np.int64)}
    path = str(tmp_path / "c.orbax")
    ckptr = ocp.StandardCheckpointer()
    ckptr.save(path, tree, save_args=jax.tree_util.tree_map(
        lambda _: ocp.SaveArgs(chunk_byte_size=400), tree))
    ckptr.wait_until_finished()
    store = ocdbt.read_store(path)
    for name, a in tree.items():
        z = json.loads(ocdbt.read_value(path, store[f"{name}/.zarray"]))
        assert z["chunks"] != list(a.shape), z
    assert sum(1 for k in store if not k.endswith(".zarray")) > 10
    assert_tree_equal(tob.load(path), tree)


@pytest.mark.parametrize("fill", [None, 1.5], ids=["null", "number"])
def test_missing_chunks_read_as_the_fill_value(tmp_path, fill):
    """A chunk never written reads as the fill value (0 for null), in the
    port as in tensorstore."""
    path = str(tmp_path / "m.orbax")
    a = np.arange(20, dtype=np.float32).reshape(5, 4) + 1
    zarray = json.loads(tob.zarray(a))
    zarray.update(chunks=[2, 4], fill_value=fill)

    def chunk(rows):
        block = np.zeros((2, 4), np.float32)
        block[:len(a[rows])] = a[rows]
        return zstd.compress(block, 1)
    ocdbt.write_store(path, iter([
        ("a/.zarray", json.dumps(zarray).encode()),
        ("a/0.0", chunk(slice(0, 2))), ("a/2.0", chunk(slice(4, 5)))]))
    meta = {"tree_metadata": {"('a',)": {
        "key_metadata": [{"key": "a", "key_type": 2}],
        "value_metadata": {"value_type": "np.ndarray",
                           "skip_deserialize": False}}},
        "use_ocdbt": True, "use_zarr3": False}
    with open(os.path.join(path, "_METADATA"), "w") as f:
        json.dump(meta, f)
    want = a.copy()
    want[2:4] = 0 if fill is None else fill
    got = tob.load(path)
    assert_tree_equal(got, {"a": want})
    assert_tree_equal(jax_restored(jck.load_orbax(path)), got)


@pytest.mark.parametrize("which", ["manifest", "node"])
def test_a_flipped_byte_raises_naming_file_and_checksum(prior, tmp_path,
                                                        which):
    path = str(tmp_path / "p.orbax")
    jck.save_orbax(prior, path)
    if which == "manifest":
        target = os.path.join(path, "manifest.ocdbt")
    else:   # the root store's one node, in its own file under d/
        target = os.path.join(path, "d", os.listdir(os.path.join(path,
                                                                 "d"))[0])
    raw = bytearray(open(target, "rb").read())
    assert struct.unpack(">I", raw[:4])[0] == (
        ocdbt.MANIFEST_MAGIC if which == "manifest" else ocdbt.NODE_MAGIC)
    raw[len(raw) // 2] ^= 0x40
    open(target, "wb").write(bytes(raw))
    with pytest.raises(ValueError, match="CRC-32C checksum") as e:
        tck.load_orbax(path)
    assert os.path.basename(target) in str(e.value)


def test_bfloat16_leaves_are_refused_naming_them(tmp_path):
    path = str(tmp_path / "b.orbax")
    ckptr = ocp.StandardCheckpointer()
    ckptr.save(path, {"w": np.ones(3, jnp.bfloat16),
                      "v": np.ones(3, np.float32)})
    ckptr.wait_until_finished()
    with pytest.raises(ValueError, match="'w'.*bfloat16"):
        tob.load(path)
    with pytest.raises(ValueError, match="'w'"):
        tob.save(str(tmp_path / "b2.orbax"), {"w": np.ones(3, jnp.bfloat16)})


# ---------------------------------------------------------------------------
# arbitrary trees, both ways
# ---------------------------------------------------------------------------

DTYPES = [np.float32, np.float64, np.int32, np.int64, np.bool_, np.uint8]


def _leaves(zero_size: bool):
    shapes = st.lists(st.integers(0 if zero_size else 1, 4), max_size=3)

    def make(args):
        dtype, shape, seed = args
        rng = np.random.default_rng(seed)
        if dtype == np.bool_:
            return rng.integers(0, 2, shape).astype(bool)
        if np.dtype(dtype).kind == "f":
            return rng.standard_normal(shape).astype(dtype)
        return rng.integers(0, 200, shape).astype(dtype)
    return st.tuples(st.sampled_from(DTYPES), shapes,
                     st.integers(0, 1000)).map(make)


def _trees(zero_size: bool):
    keys = st.text("abcxyz_0123456789", min_size=1, max_size=5)
    return st.recursive(
        _leaves(zero_size) | st.none(),
        lambda inner: st.lists(inner, min_size=1, max_size=3)
        | st.dictionaries(keys, inner, min_size=1, max_size=3),
        max_leaves=8).filter(lambda t: isinstance(t, dict)) | \
        st.dictionaries(keys, _leaves(zero_size), min_size=1, max_size=3)


@settings(max_examples=6, deadline=None,
          suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(tree=_trees(zero_size=True))
def test_port_writes_what_jax_restores(tmp_path_factory, tree):
    """Nested dicts and lists of f32, f64, i32, i64, bool and u8 leaves,
    0-d and 0-size among them, and None: the port's save restored by
    orbax, and by the port, bit for bit."""
    path = str(tmp_path_factory.mktemp("h") / "t.orbax")
    tob.save(path, tree)
    assert_tree_equal(jax_restored(ocp.StandardCheckpointer().restore(path)),
                      tree)
    assert_tree_equal(tob.load(path), tree)


@settings(max_examples=6, deadline=None,
          suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(tree=_trees(zero_size=False))
def test_jax_writes_what_the_port_reads(tmp_path_factory, tree):
    """The same trees (orbax refuses 0-size arrays) written by orbax and
    read by the port as orbax restores them."""
    path = str(tmp_path_factory.mktemp("h") / "t.orbax")
    ckptr = ocp.StandardCheckpointer()
    ckptr.save(path, tree)
    ckptr.wait_until_finished()
    assert_tree_equal(tob.load(path), jax_restored(ckptr.restore(path)))
    assert_tree_equal(tob.load(path), tree)


# ---------------------------------------------------------------------------
# trainer checkpoints, both ways
# ---------------------------------------------------------------------------

def test_jax_trainer_checkpoint_resumes_in_the_port(data, tmp_path):
    """JAX Trainer.save_checkpoint(fmt='orbax') -> the port's
    load_checkpoint: parameters, batch statistics, Adam's mu, nu and
    count, and the step, bit for bit; the same eval; a trainer of another
    optimizer refuses it naming opt_state."""
    jt = jax_trainer(data, epochs=1)
    tt = port_trainer(data, jt, epochs=1)
    jt.train(log_fn=lambda *_: None)
    path = jt.save_checkpoint(str(tmp_path), 0, 1.0, fmt="orbax")
    assert path.endswith("0.orbax") and os.path.isdir(path)
    assert tt.load_checkpoint(path) == int(jt.state.step) == 6
    assert_tree_equal(params_to_flax(tt.model.state_dict()),
                      _np(jt.variables))
    to, jo = tt.opt_state(), _np(jt.state.opt_state)
    assert to["0"]["count"].dtype == np.int32
    assert int(to["0"]["count"]) == int(jo[0].count) == 6
    _moments_equal(to, jo)
    assert tt.evaluate() == pytest.approx(jt.evaluate(), rel=1e-5)
    other = port_trainer(data, jt, epochs=1, **OPTIMIZERS["adamw"])
    with pytest.raises(ValueError, match="opt_state"):
        other.load_checkpoint(path)


@pytest.mark.parametrize("opt", sorted(OPTIMIZERS))
def test_port_trainer_checkpoint_resumes_in_jax(data, tmp_path, opt):
    """The port's save_checkpoint(fmt='orbax') -> JAX Trainer.
    load_checkpoint (orbax's restore into the trainer's target, which
    compares the tree with its optax states): the same step, moments and
    counts, and the next epoch starts from evals equal at 1e-5 relative.
    That epoch, run in both, ends within the 5 % tests/test_torch_train.py
    holds whole runs to (float32 rounding grows over 6 steps: 5e-4
    relative for Adam)."""
    jt = jax_trainer(data, epochs=1, **OPTIMIZERS[opt])
    tt = port_trainer(data, jt, epochs=1, **OPTIMIZERS[opt])
    tt.train(log_fn=lambda *_: None, checkpoint_dir=str(tmp_path),
             checkpoint_format="orbax")
    assert sorted(os.listdir(tmp_path)) == ["0.json", "0.orbax"]
    jt.load_checkpoint(str(tmp_path / "0.orbax"))
    assert int(jt.state.step) == tt.step == 6
    jo = _np(jt.state.opt_state)
    assert int(jo[0].count) == 6
    if opt == "cosine":
        assert int(jo[-1].count) == 6
    _moments_equal(tt.opt_state(), jo)
    assert_tree_equal(_np(jt.variables), params_to_flax(
        tt.model.state_dict()))
    assert tt.evaluate() == pytest.approx(jt.evaluate(), rel=1e-5)
    jt.train(log_fn=lambda *_: None)
    tt.train(log_fn=lambda *_: None)
    assert int(jt.state.step) == tt.step == 12
    assert tt.evaluate() == pytest.approx(jt.evaluate(), rel=0.05)


# ---------------------------------------------------------------------------
# the JAX-written fixture
# ---------------------------------------------------------------------------

def fixture_leaves(root):
    """The port's reading of a fixture directory, keyed as
    expected.npz."""
    sys.path.insert(0, FIXTURE)
    try:
        from make_fixture import leaves
    finally:
        sys.path.remove(FIXTURE)
    got = leaves(tck.load_orbax(os.path.join(root, "prior.orbax")), "prior")
    got.update(leaves(tck.load_orbax(os.path.join(root, "checkpoints",
                                                  "0.orbax")), "epoch"))
    return got


def test_fixture_is_what_jax_writes(tmp_path):
    """The committed fixture and one JAX writes afresh read in the port to
    the same leaves, both equal to expected.npz: the fixture cannot drift
    from the JAX package's writers."""
    sys.path.insert(0, FIXTURE)
    try:
        import make_fixture
    finally:
        sys.path.remove(FIXTURE)
    fresh = make_fixture.build(str(tmp_path))
    expected = dict(np.load(os.path.join(FIXTURE, "expected.npz")))
    committed = fixture_leaves(FIXTURE)
    rebuilt = fixture_leaves(str(tmp_path))
    assert sorted(committed) == sorted(rebuilt) == sorted(expected) == \
        sorted(fresh)
    for k, want in expected.items():
        for got in (committed[k], rebuilt[k], fresh[k]):
            assert (got.dtype, got.shape) == (want.dtype, want.shape), k
            np.testing.assert_array_equal(got, want, err_msg=k)
    with open(os.path.join(FIXTURE, "checkpoints", "0.json")) as f:
        assert json.load(f)["epoch"] == 1
