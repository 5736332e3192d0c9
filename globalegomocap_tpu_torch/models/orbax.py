"""Orbax checkpoint directories, read and written without orbax or
tensorstore.

Counterpart of `save_orbax` / `load_orbax` in
`globalegomocap_tpu/models/checkpoint.py` (`ocp.StandardCheckpointer`
of orbax 0.11 over numpy leaves).  A checkpoint directory holds:

- `_CHECKPOINT_METADATA`: JSON naming the handler, with timestamps;
- `_METADATA`: JSON whose `tree_metadata` maps the string form of each
  leaf's key tuple to its `key_metadata` (per level the key and its
  `key_type`: 2 a dict key, 1 a sequence index) and `value_metadata`
  (`value_type` "np.ndarray" or "jax.Array" for arrays; "None",
  "Dict", "List" or "Tuple" with `skip_deserialize` for None and empty
  containers), with `use_ocdbt: true` and `use_zarr3: false`;
- an OCDBT store (`models/ocdbt.py`) holding per array a zarr v2
  `<dotted.path>/.zarray` (shape, chunks, dtype such as "<f4",
  `compressor` zstd level 1, C order, `fill_value` null, "." separating
  chunk indices) and its chunks `<dotted.path>/<i.j...>` ("0" for a 0-d
  array), each one zstd frame of the chunk's C-order bytes.  Edge chunks
  are stored whole; a missing chunk reads as the fill value (0 for
  null).  `_sharding` and `array_metadatas/` (from `jax.Array` leaves)
  are not needed to read and are ignored.

`load` returns the tree `ocp.StandardCheckpointer().restore(path)`
returns: dicts, lists where the key type is a sequence index, None,
numpy arrays.  A bfloat16 leaf raises ValueError naming it (numpy has no
such dtype; the priors and the trainer's state are float32), as does a
leaf of a type orbax gives Python scalars ("scalar"), which no
checkpoint of this project holds.

`save` writes what `StandardCheckpointer().save` writes for a tree of
dicts, lists or tuples, numpy arrays or scalars and None: one chunk an
array, compressed by the system's libzstd (`native/zstd.py`), each array
copied once from its buffer into its compressed frame and written from
there.  The OCDBT store is one generation with one leaf node and no
`ocdbt.process_0/`, which tensorstore reads (ROADMAP §C).  Like orbax it
writes into a temporary directory renamed at the end, and refuses a
destination that exists.
"""

from __future__ import annotations

import json
import math
import os
import shutil
import time

import numpy as np

from globalegomocap_tpu_torch.models import ocdbt
from globalegomocap_tpu_torch.native import zstd

HANDLER = ("orbax.checkpoint._src.handlers.standard_checkpoint_handler."
           "StandardCheckpointHandler")
CHECKPOINT_METADATA = "_CHECKPOINT_METADATA"
METADATA = "_METADATA"
DICT_KEY, SEQUENCE_KEY = 2, 1
ZSTD_LEVEL = 1
_EMPTY = {"Dict": dict, "List": list, "Tuple": tuple}
_ARRAY_TYPES = ("np.ndarray", "jax.Array")


# ---------------------------------------------------------------------------
# writing
# ---------------------------------------------------------------------------

def _flatten(tree, keys=()):
    """(keys, leaf) pairs in JAX's flattening order (dict keys sorted,
    sequences by index); keys are (str, key type) pairs; an empty
    container is a leaf."""
    if isinstance(tree, dict):
        if not tree:
            yield keys, tree
        for k in sorted(tree):
            if not isinstance(k, str):
                raise ValueError(f"orbax: dict key {k!r} is not a string")
            yield from _flatten(tree[k], keys + ((k, DICT_KEY),))
    elif isinstance(tree, (list, tuple)):
        if not tree:
            yield keys, tree
        for i, v in enumerate(tree):
            yield from _flatten(v, keys + ((str(i), SEQUENCE_KEY),))
    else:
        yield keys, tree


def _leaf_array(keys, leaf) -> np.ndarray:
    name = ".".join(k for k, _ in keys)
    if isinstance(leaf, np.generic):
        leaf = np.asarray(leaf)
    if not isinstance(leaf, np.ndarray):
        raise ValueError(f"orbax: leaf {name!r} is a "
                         f"{type(leaf).__name__}; numpy arrays, numpy "
                         "scalars and None are written")
    if leaf.dtype.hasobject or leaf.dtype.names is not None \
            or leaf.dtype.kind not in "biuf":
        raise ValueError(f"orbax: leaf {name!r} of dtype {leaf.dtype} is "
                         "not written")
    # astype keeps a 0-d array 0-d (ascontiguousarray would not)
    return leaf.astype(leaf.dtype.newbyteorder("<"), order="C", copy=False)


def zarray(a: np.ndarray) -> bytes:
    """The `.zarray` tensorstore writes for a one-chunk array."""
    return json.dumps({
        "chunks": [max(1, n) for n in a.shape],
        "compressor": {"id": "zstd", "level": ZSTD_LEVEL},
        "dimension_separator": ".", "dtype": a.dtype.str,
        "fill_value": None, "filters": None, "order": "C",
        "shape": list(a.shape), "zarr_format": 2},
        sort_keys=True, separators=(",", ":")).encode()


def _store_values(arrays):
    for name, a in arrays:
        yield f"{name}/.zarray", zarray(a)
        if a.size:
            yield f"{name}/{'.'.join(['0'] * a.ndim) or '0'}", \
                zstd.compress(a, ZSTD_LEVEL)


def save(path: str, tree) -> None:
    """Write `tree` as an Orbax checkpoint directory at `path`, as
    `ocp.StandardCheckpointer().save(path, tree)` does; a `path` that
    exists raises ValueError."""
    path = os.path.abspath(path)
    if os.path.exists(path):
        raise ValueError(f"Destination {path} already exists.")
    t0 = time.time_ns()
    meta, arrays = {}, []
    for keys, leaf in _flatten(tree):
        key_meta = [{"key": k, "key_type": t} for k, t in keys]
        if leaf is None or (isinstance(leaf, (dict, list, tuple))
                            and not leaf):
            vtype = "None" if leaf is None else type(leaf).__name__.title()
            value = {"value_type": vtype, "skip_deserialize": True}
        else:
            arrays.append((".".join(k for k, _ in keys),
                           _leaf_array(keys, leaf)))
            value = {"value_type": "np.ndarray", "skip_deserialize": False}
        meta[str(tuple(k for k, _ in keys))] = {"key_metadata": key_meta,
                                                "value_metadata": value}
    tmp = f"{path}.orbax-checkpoint-tmp-{t0}"
    try:
        ocdbt.write_store(tmp, _store_values(arrays))
        # json.dumps, not json.dump: the C encoder, one write
        with open(os.path.join(tmp, METADATA), "w") as f:
            f.write(json.dumps({
                "tree_metadata": meta, "use_ocdbt": True,
                "use_zarr3": False,
                "store_array_data_equal_to_fill_value": True,
                "custom_metadata": None}))
        with open(os.path.join(tmp, CHECKPOINT_METADATA), "w") as f:
            f.write(json.dumps({
                "item_handlers": HANDLER, "metrics": {},
                "performance_metrics": {}, "init_timestamp_nsecs": t0,
                "commit_timestamp_nsecs": time.time_ns(),
                "custom_metadata": {}}))
        os.rename(tmp, path)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise


# ---------------------------------------------------------------------------
# reading
# ---------------------------------------------------------------------------

def _read_array(root: str, store: dict, name: str) -> np.ndarray:
    key = f"{name}/.zarray"
    if key not in store:
        raise ValueError(f"orbax: {root}: no {key} in the OCDBT store")
    z = json.loads(ocdbt.read_value(root, store[key]))
    try:
        dtype = np.dtype(z["dtype"])
    except TypeError:
        dtype = None
    if dtype is None or dtype.kind not in "biuf":
        # bfloat16 among them, even where ml_dtypes taught numpy its name
        raise ValueError(f"orbax: {root}: leaf {name!r} of dtype "
                         f"{z['dtype']!r} is not read (numpy has no such "
                         "dtype)")
    if z.get("zarr_format") != 2 or z.get("order") != "C" \
            or z.get("filters") or (z.get("compressor") or {}).get(
                "id") != "zstd":
        raise ValueError(f"orbax: {root}: leaf {name!r}: an unsupported "
                         f"zarr array {z}")
    shape, chunks = tuple(z["shape"]), tuple(z["chunks"])
    sep = z.get("dimension_separator", ".")
    out = np.empty(shape, dtype)
    grid = [math.ceil(s / c) for s, c in zip(shape, chunks)]
    one = np.empty(chunks, dtype) if chunks != shape else None
    for idx in np.ndindex(*grid):
        sl = tuple(slice(i * c, min((i + 1) * c, s))
                   for i, c, s in zip(idx, chunks, shape))
        value = store.get(f"{name}/{sep.join(map(str, idx)) or '0'}")
        if value is None:       # a chunk never written: the fill value
            fill = z.get("fill_value")
            out[sl] = 0 if fill is None else fill
            continue
        dst = out if one is None else one
        frame = np.empty(value.length if isinstance(value, ocdbt.Ref)
                         else len(value), np.uint8)
        ocdbt.read_value_into(root, value, frame)
        zstd.decompress_into(frame, dst)
        if one is not None:
            out[sl] = one[tuple(slice(0, s.stop - s.start) for s in sl)]
    return out


def _build(entries: list):
    """Nested dicts and lists from (key_metadata, value) pairs."""
    root: dict = {}
    kinds: dict = {}
    for key_meta, value in entries:
        node, path = root, ()
        for level, km in enumerate(key_meta):
            k = km["key"]
            path += (k,)
            kinds.setdefault(path[:-1], km["key_type"])
            if level == len(key_meta) - 1:
                node[k] = value
            else:
                node = node.setdefault(k, {})

    def convert(node, path):
        if not isinstance(node, dict):
            return node
        items = {k: convert(v, path + (k,)) for k, v in node.items()}
        if kinds.get(path) == SEQUENCE_KEY:
            return [items[k] for k in sorted(items, key=int)]
        return items
    return convert(root, ())


def load(path: str):
    """The tree `ocp.StandardCheckpointer().restore(path)` returns for
    an Orbax checkpoint directory (no target): dicts, lists, None and
    numpy leaves.  Every manifest and node checksum is checked."""
    path = os.path.abspath(path)
    meta_path = os.path.join(path, METADATA)
    meta = None
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
    # orbax writes no store for a tree without arrays
    if meta is None or any(
            leaf["value_metadata"]["value_type"] in _ARRAY_TYPES
            for leaf in meta["tree_metadata"].values()):
        store = ocdbt.read_store(path)
    if meta is None:
        raise FileNotFoundError(f"orbax: {path} holds no {METADATA}")
    if not meta.get("use_ocdbt", False) or meta.get("use_zarr3", False):
        raise ValueError(f"orbax: {path}: only OCDBT stores of zarr v2 "
                         "arrays are read")
    entries = []
    for name, leaf in meta["tree_metadata"].items():
        vm, km = leaf["value_metadata"], leaf["key_metadata"]
        vtype = vm["value_type"]
        if vtype in _ARRAY_TYPES:
            value = _read_array(path, store,
                                ".".join(str(k["key"]) for k in km))
        elif vtype == "None":
            value = None
        elif vtype in _EMPTY:
            value = _EMPTY[vtype]()
        else:
            raise ValueError(f"orbax: {path}: leaf {name} of value type "
                             f"{vtype!r} is not read")
        entries.append((km, value))
    return _build(entries)
