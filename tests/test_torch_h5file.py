"""The port's own HDF5 reader and writer (`data/h5file.py`) against h5py
and the JAX package's `data/hdf5.py`.

The reader reads files h5py wrote in every form a window corpus takes at
h5py's defaults and a few it may take beyond them (JAX's
`pack_amass_dir`, 0 rows, one and several appends, a resize with no
write, a multi-level chunk B-tree, a contiguous dataset, gzip with
shuffle, float64, more datasets than one SNOD holds, an object header
continued by attributes) to h5py's arrays, whole and in row ranges; the
features it does not take raise, naming them.  h5py and JAX read the
writer's files, including B-trees of two and three levels, to the
arrays written; JAX's stream yields the port's batches on them.  Every
array is held bit for bit: both sides only copy stored bytes."""

import os
import pickle

import h5py
import numpy as np
import pytest

import tests.torch_port_helpers  # noqa: F401  (one torch thread a worker)
from globalegomocap_tpu.data import hdf5 as jh5
from globalegomocap_tpu.data.synthetic import synthetic_amass
from globalegomocap_tpu_torch.data import h5file
from globalegomocap_tpu_torch.data import hdf5 as th5

POSES = {"relative_global_pose": (10, 15, 3), "local_pose": (10, 15, 3),
         "camera_matrix": (10, 4, 4)}


def _rows(n, shape, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(n,) + tuple(shape)).astype(dtype)


def _store(path, shapes, counts, dtype=np.float32):
    """JAX's HDF5Store (h5py at its defaults), appended `counts` rows."""
    store = jh5.HDF5Store(path, shapes, dtype)
    for i, n in enumerate(counts):
        store.append({k: _rows(n, s, 10 * i + j, dtype)
                      for j, (k, s) in enumerate(shapes.items())})


def _jax_pack(path):
    d = os.path.join(os.path.dirname(path), "amass")
    os.makedirs(d)
    for i, s in enumerate(synthetic_amass(n_sequences=3, frames_per_seq=40,
                                          seed=9)):
        with open(os.path.join(d, f"seq_{i}.pkl"), "wb") as f:
            pickle.dump(s, f)
    jh5.pack_amass_dir(d, path, frame_num=10)


def _fill(path):
    with h5py.File(path, "w") as f:
        d = f.create_dataset("set", shape=(0, 3), maxshape=(None, 3),
                             dtype=np.float32, chunks=(4, 3), fillvalue=2.5)
        d.resize((5, 3))
        d[:] = _rows(5, (3,), 0)
        d.resize((21, 3))                   # rows 5..20: chunks never written
        d = f.create_dataset("zero", shape=(0, 10, 4, 4),
                             maxshape=(None, 10, 4, 4), dtype=np.float32)
        d.resize((300, 10, 4, 4))


def _multilevel(path):
    with h5py.File(path, "w") as f:
        d = f.create_dataset("x", shape=(0, 3), maxshape=(None, 3),
                             chunks=(1, 3), dtype=np.float64)
        d.resize((200, 3))                  # 200 chunks: two levels
        d[:] = _rows(200, (3,), 1, np.float64)


def _contiguous(path):
    with h5py.File(path, "w") as f:
        f.create_dataset("x", data=_rows(50, (10, 4), 2))
        f.create_dataset("unwritten", shape=(6, 2), dtype=np.float64)


def _gzip(path):
    with h5py.File(path, "w") as f:
        kw = dict(chunks=(7, 10, 15, 3))
        f.create_dataset("both", data=_rows(300, (10, 15, 3), 3),
                         compression="gzip", shuffle=True, **kw)
        f.create_dataset("gzip", data=_rows(30, (10, 15, 3), 4),
                         compression="gzip", compression_opts=9, **kw)
        f.create_dataset("shuffle", data=_rows(30, (10, 15, 3), 5),
                         shuffle=True, **kw)


def _many(path):
    with h5py.File(path, "w") as f:            # three SNODs of names
        for i in range(20):
            f.create_dataset(f"d{19 - i:02d}", data=_rows(3, (2,), i))


def _continued(path):
    _store(path, {"x": (3,)}, [10])
    with h5py.File(path, "a") as f:         # attributes outgrow the header
        for i in range(40):
            f["x"].attrs[f"a{i}"] = np.arange(20.0)
        f["x"].resize((25, 3))
        f["x"][10:] = _rows(15, (3,), 6)


READ_CASES = {
    "jax_pack": _jax_pack,
    "empty": lambda p: _store(p, POSES, []),
    "one_append": lambda p: _store(p, POSES, [300]),
    "appends": lambda p: _store(p, POSES, [5, 250, 1, 700]),
    "fill": _fill,
    "multilevel": _multilevel,
    "contiguous": _contiguous,
    "gzip_shuffle": _gzip,
    "float64": lambda p: _store(p, {"x": (10, 15, 3), "y": (2,)}, [3, 600],
                                np.float64),
    "many": _many,
    "continued": _continued,
}


@pytest.mark.parametrize("case", READ_CASES)
def test_reader_reads_h5py_files(tmp_path, case):
    """Names in h5py's order; each dataset's shape, maxshape, chunks,
    dtype and fill value; its rows whole and in ranges that start and end
    inside chunks, equal to h5py's bit for bit."""
    path = str(tmp_path / "ref.h5")
    READ_CASES[case](path)
    with h5py.File(path, "r") as f, h5file.open(path) as g:
        assert list(g) == list(f) and len(g) == len(f) > 0
        for name in f:
            want, got = f[name], g[name]
            assert got.shape == want.shape and got.dtype == want.dtype
            assert got.maxshape == want.maxshape
            assert got.chunks == want.chunks
            assert got.fillvalue == want.fillvalue
            a = got.read()
            assert a.dtype == want.dtype and np.array_equal(a, want[()])
            n = want.shape[0]
            for lo, hi in ((0, 1), (n // 3, n - n // 5), (n - 1, n),
                           (n, n), (2, 10 * n)):
                b = got.read(lo, hi)
                assert np.array_equal(b, want[lo:hi]), (name, lo, hi)
        if case == "continued":
            assert 0x10 in g["x"]._at               # a continuation message
        if case == "many":
            assert len(f) > 2 * h5file.LEAF_K      # more than one SNOD


def _refused(path, kind):
    if kind == "not_hdf5":
        with open(path, "wb") as f:
            f.write(b"not an hdf5 file")
        return
    with h5py.File(path, "w", libver="latest" if kind == "latest"
                   else "earliest") as f:
        if kind == "latest":
            f["x"] = np.zeros(3, np.float32)
        elif kind == "int":
            f["x"] = np.arange(3, dtype=np.int32)
        elif kind == "big_endian":
            f["x"] = np.zeros(3, ">f4")
        elif kind == "float16":
            f["x"] = np.zeros(3, np.float16)
        elif kind == "fletcher32":
            f.create_dataset("x", data=np.zeros(4, np.float32),
                             fletcher32=True, chunks=(2,))


@pytest.mark.parametrize("kind,error,match", [
    ("latest", ValueError, "superblock version 3"),
    ("int", ValueError, "datatype class 0"),
    ("big_endian", ValueError, "big-endian"),
    ("float16", ValueError, "16-bit float"),
    ("fletcher32", ValueError, "filter id 3 .fletcher32"),
    ("not_hdf5", OSError, "not an HDF5 file")])
def test_reader_refuses_what_it_does_not_take(tmp_path, kind, error, match):
    path = str(tmp_path / "x.h5")
    _refused(path, kind)
    with pytest.raises(error, match=match):
        h5file.open(path)


def _write(path, shapes, counts, dtype=np.float32):
    """The port's HDF5Store over `counts` appends; the rows written."""
    store = th5.HDF5Store(path, shapes, dtype)
    parts = {k: [] for k in shapes}
    for i, n in enumerate(counts):
        batch = {k: _rows(n, s, 10 * i + j, dtype)
                 for j, (k, s) in enumerate(shapes.items())}
        store.append(batch)
        for k, v in batch.items():
            parts[k].append(v)
    return {k: np.concatenate(v) if v else np.zeros((0,) + shapes[k], dtype)
            for k, v in parts.items()}


WRITE_CASES = {   # shapes, appends, dtype, CHUNK_BYTES, B-tree levels
    "store": (POSES, [5, 700, 1, 1294], np.float32, None, 1),
    "rank1_float64": ({"x": (2,)}, [3, 9], np.float64, None, 1),
    "empty": (POSES, [], np.float32, None, 0),
    "over_64_chunks": (POSES, [1, 999, 1000], np.float32, 4096, 2),
    "three_levels": ({"x": (4,)}, [4200, 1], np.float32, 16, 3),
}


@pytest.mark.parametrize("case", WRITE_CASES)
def test_writer_files_read_by_h5py_and_jax(tmp_path, monkeypatch, case):
    """h5py reads the port's files to the rows appended, with the first
    dimension unlimited and whole-row chunks of at most CHUNK_BYTES; the
    chunk B-tree has the levels its chunk count needs (64 a node); JAX's
    `load_hdf5_windows` and `HDF5WindowStream` read the pose files as the
    port's reader does, batch for batch from one seed."""
    shapes, counts, dtype, chunk_bytes, levels = WRITE_CASES[case]
    if chunk_bytes:
        monkeypatch.setattr(h5file, "CHUNK_BYTES", chunk_bytes)
    path = str(tmp_path / "port.h5")
    rows = _write(path, shapes, counts, dtype)
    with h5py.File(path, "r") as f, h5file.open(path) as g:
        assert list(f) == list(g) == sorted(shapes)
        for name, want in rows.items():
            d = f[name]
            assert d.dtype == want.dtype and d.maxshape == (None,) + \
                shapes[name]
            row = want.dtype.itemsize * int(np.prod(shapes[name]))
            assert d.chunks[1:] == shapes[name]
            assert d.chunks[0] * row <= max(h5file.CHUNK_BYTES, row)
            assert np.array_equal(d[()], want)
            assert np.array_equal(g[name].read(), want)
            if want.shape[0] > 3:
                assert np.array_equal(d[3:-1], g[name].read(3, len(want) - 1))
            addr = g[name]._addr
            got_levels = 0 if addr == h5file.UNDEF else 1 + os.pread(
                g.fd(), 6, addr)[5]
            assert got_levels == levels
    if shapes is not POSES or not counts:
        return
    for local in (False, True):
        a = th5.load_hdf5_windows(path, local_pose=local).windows
        b = jh5.load_hdf5_windows(path, local_pose=local).windows
        assert np.array_equal(a, b)
    t = th5.HDF5WindowStream(path, slab_size=300, start=7, stop=-11)
    j = jh5.HDF5WindowStream(path, slab_size=300, start=7, stop=-11)
    rt, rj = np.random.default_rng(5), np.random.default_rng(5)
    bt, bj = list(t.epoch_batches(rt, 64)), list(j.epoch_batches(rj, 64))
    assert len(bt) == len(bj) == (len(rows["local_pose"]) - 18) // 64
    assert all(np.array_equal(x, y) for x, y in zip(bt, bj))
    assert rt.random() == rj.random()
    t.close(), j.close()


def test_writer_refuses_what_it_did_not_write(tmp_path):
    """Rows of another shape, and appends to a file h5py wrote (its N-d
    chunks), raise ValueError; a closed file's dataset does not read."""
    path = str(tmp_path / "port.h5")
    th5.HDF5Store(path, {"x": (3,)})
    with pytest.raises(ValueError, match="rows of shape"):
        h5file.append(path, {"x": np.zeros((2, 4), np.float32)})
    other = str(tmp_path / "h5py.h5")
    _store(other, POSES, [3])
    with pytest.raises(ValueError, match="not written by h5file.create"):
        h5file.append(other, {"local_pose": np.zeros((1, 10, 15, 3))})
    with pytest.raises(ValueError, match="float32 or float64"):
        h5file.create(str(tmp_path / "i.h5"), {"x": (3,)}, np.int32)
    h5file.append(path, {"x": np.zeros((2, 3), np.float32)})
    g = h5file.open(path)
    d = g["x"]
    g.close()
    with pytest.raises(ValueError, match="closed"):
        d.read()
