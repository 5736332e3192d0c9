"""Prior checkpoints in flax's msgpack format, read and written without
msgpack or flax.

Counterpart of `load_msgpack` / `save_msgpack` in
`globalegomocap_tpu/models/checkpoint.py`, which go through
`flax.serialization.msgpack_serialize` / `msgpack_restore`: a msgpack
map of the variables tree whose array leaves are ext type 1 carrying the
msgpack array (shape, dtype name, C-order bytes), and numpy scalars ext
type 3 in the same encoding (as the JAX trainer's checkpoints may hold).
The coder is the port's own small one, because the card's machine has
neither package.  Maps, strings, bin, ints, floats, nil, bools and
arrays are read and written; `save_msgpack` writes maps with their keys
sorted, as `jax.device_get` leaves them, so a file it writes has the
bytes of the JAX package's for the same variables.  Not read: flax's
chunked leaves (arrays over 2**30 bytes; the full-width prior's largest
is 42 MB), bfloat16 arrays (numpy has no such dtype; the priors are
float32) and complex numbers.

Orbax checkpoint directories go through the port's own reader and writer
(`models/orbax.py`): `save_orbax` and `load_orbax` are the JAX
package's, with numpy leaves.

The trainer's epoch checkpoints (`train/train_vae.py`) are one such file,
or one Orbax directory, of {'params', 'batch_stats', 'opt_state', 'step'},
the payload of the JAX `Trainer.save_checkpoint`: int32 0-d counts and
step, as `jax.device_get` leaves them (`save_train_state`,
`load_train_state`).  Orbax keeps optax's tuple of states as a list with
None for an EmptyState, flax's msgpack as a dict keyed '0', '1', ... with
{} for one; the trainer works in the msgpack layout and the Orbax branch
maps it (`optax_to_orbax`, `optax_from_orbax`).
`load_prior_variables` reads a prior from any file or directory the JAX
package's does.
"""

from __future__ import annotations

import os
import struct
from typing import Any

import numpy as np

from globalegomocap_tpu_torch.models import orbax

_EXT_NDARRAY, _EXT_NPSCALAR = 1, 3


# ---------------------------------------------------------------------------
# the encoder
# ---------------------------------------------------------------------------

def _pack_len(out: list, n: int, fix: int | None, fix_max: int,
              codes: tuple) -> None:
    """A container or string header: the fix form below fix_max, else
    the 8-, 16- or 32-bit length form (codes may start with None where
    the format has no 8-bit form)."""
    if fix is not None and n < fix_max:
        out.append(bytes([fix | n]))
    elif codes[0] is not None and n < 1 << 8:
        out.append(struct.pack(">BB", codes[0], n))
    elif n < 1 << 16:
        out.append(struct.pack(">BH", codes[1], n))
    elif n < 1 << 32:
        out.append(struct.pack(">BI", codes[2], n))
    else:
        raise ValueError(f"msgpack: an object of {n} elements or bytes is "
                         "too large")


def _pack_int(out: list, v: int) -> None:
    if 0 <= v < 128:
        out.append(bytes([v]))
    elif -32 <= v < 0:
        out.append(struct.pack(">b", v))
    elif v >= 0:
        for code, fmt, top in ((0xcc, ">BB", 1 << 8), (0xcd, ">BH", 1 << 16),
                               (0xce, ">BI", 1 << 32),
                               (0xcf, ">BQ", 1 << 64)):
            if v < top:
                out.append(struct.pack(fmt, code, v))
                return
        raise ValueError(f"msgpack: integer {v} is too large")
    else:
        for code, fmt, low in ((0xd0, ">Bb", -(1 << 7)),
                               (0xd1, ">Bh", -(1 << 15)),
                               (0xd2, ">Bi", -(1 << 31)),
                               (0xd3, ">Bq", -(1 << 63))):
            if v >= low:
                out.append(struct.pack(fmt, code, v))
                return
        raise ValueError(f"msgpack: integer {v} is too small")


def _pack_ext(out: list, code: int, data: bytes) -> None:
    n = len(data)
    fixed = {1: 0xd4, 2: 0xd5, 4: 0xd6, 8: 0xd7, 16: 0xd8}
    if n in fixed:
        out.append(struct.pack(">Bb", fixed[n], code))
    else:
        _pack_len(out, n, None, 0, (0xc7, 0xc8, 0xc9))
        out.append(struct.pack(">b", code))
    out.append(data)


def _ndarray_bytes(a: np.ndarray) -> bytes:
    if a.dtype.hasobject or a.dtype.names is not None:
        raise ValueError("msgpack: object and structured arrays are not "
                         "supported")
    return packb((tuple(a.shape), a.dtype.name, a.tobytes("C")))


def _pack(out: list, x: Any, sort_keys: bool) -> None:
    if x is None:
        out.append(b"\xc0")
    elif x is True or x is False:
        out.append(b"\xc3" if x else b"\xc2")
    elif isinstance(x, np.ndarray):
        _pack_ext(out, _EXT_NDARRAY, _ndarray_bytes(x))
    elif isinstance(x, np.generic):
        _pack_ext(out, _EXT_NPSCALAR, _ndarray_bytes(np.asarray(x)))
    elif type(x) is int:
        _pack_int(out, x)
    elif type(x) is float:
        out.append(struct.pack(">Bd", 0xcb, x))
    elif type(x) is str:
        raw = x.encode("utf-8")
        _pack_len(out, len(raw), 0xa0, 32, (0xd9, 0xda, 0xdb))
        out.append(raw)
    elif type(x) in (bytes, bytearray, memoryview):
        raw = bytes(x)
        _pack_len(out, len(raw), None, 0, (0xc4, 0xc5, 0xc6))
        out.append(raw)
    elif type(x) in (list, tuple):
        _pack_len(out, len(x), 0x90, 16, (None, 0xdc, 0xdd))
        for v in x:
            _pack(out, v, sort_keys)
    elif isinstance(x, dict):
        _pack_len(out, len(x), 0x80, 16, (None, 0xde, 0xdf))
        items = sorted(x.items()) if sort_keys else x.items()
        for k, v in items:
            _pack(out, k, sort_keys)
            _pack(out, v, sort_keys)
    else:
        raise ValueError(f"msgpack: cannot write a {type(x).__name__}")


def packb(x: Any, sort_keys: bool = False) -> bytes:
    """x as msgpack bytes (flax's ext types for arrays and numpy
    scalars)."""
    out: list = []
    _pack(out, x, sort_keys)
    return b"".join(out)


# ---------------------------------------------------------------------------
# the decoder
# ---------------------------------------------------------------------------

class _Reader:
    def __init__(self, data: bytes, raw: bool):
        self.data = memoryview(data)
        self.pos = 0
        self.raw = raw          # strings as bytes (flax's inner decode)

    def take(self, n: int) -> memoryview:
        end = self.pos + n
        if end > len(self.data):
            raise ValueError("msgpack: the data ends inside an object "
                             "(a truncated file?)")
        out = self.data[self.pos:end]
        self.pos = end
        return out

    def unpack_from(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def string(self, n: int):
        raw = bytes(self.take(n))
        return raw if self.raw else raw.decode("utf-8")

    def ext(self, n: int):
        code = self.unpack_from(">b")
        return _ext_value(code, bytes(self.take(n)))

    def read(self) -> Any:
        b = self.unpack_from(">B")
        if b < 0x80:
            return b
        if b >= 0xe0:
            return b - 0x100
        if b <= 0x8f:
            return self.map(b & 0x0f)
        if b <= 0x9f:
            return [self.read() for _ in range(b & 0x0f)]
        if b <= 0xbf:
            return self.string(b & 0x1f)
        u = self.unpack_from
        fixed = {
            0xc0: lambda: None, 0xc2: lambda: False, 0xc3: lambda: True,
            0xc4: lambda: bytes(self.take(u(">B"))),
            0xc5: lambda: bytes(self.take(u(">H"))),
            0xc6: lambda: bytes(self.take(u(">I"))),
            0xc7: lambda: self.ext(u(">B")),
            0xc8: lambda: self.ext(u(">H")),
            0xc9: lambda: self.ext(u(">I")),
            0xca: lambda: u(">f"), 0xcb: lambda: u(">d"),
            0xcc: lambda: u(">B"), 0xcd: lambda: u(">H"),
            0xce: lambda: u(">I"), 0xcf: lambda: u(">Q"),
            0xd0: lambda: u(">b"), 0xd1: lambda: u(">h"),
            0xd2: lambda: u(">i"), 0xd3: lambda: u(">q"),
            0xd4: lambda: self.ext(1), 0xd5: lambda: self.ext(2),
            0xd6: lambda: self.ext(4), 0xd7: lambda: self.ext(8),
            0xd8: lambda: self.ext(16),
            0xd9: lambda: self.string(u(">B")),
            0xda: lambda: self.string(u(">H")),
            0xdb: lambda: self.string(u(">I")),
            0xdc: lambda: [self.read() for _ in range(u(">H"))],
            0xdd: lambda: [self.read() for _ in range(u(">I"))],
            0xde: lambda: self.map(u(">H")),
            0xdf: lambda: self.map(u(">I")),
        }
        if b not in fixed:
            raise ValueError(f"msgpack: byte 0x{b:02x} at {self.pos - 1} "
                             "starts no object")
        return fixed[b]()

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.read()
            out[k] = self.read()
        return out


def unpackb(data: bytes, raw: bool = False) -> Any:
    """One msgpack object from `data`; trailing bytes raise ValueError."""
    r = _Reader(data, raw)
    out = r.read()
    if r.pos != len(r.data):
        raise ValueError(f"msgpack: {len(r.data) - r.pos} bytes follow the "
                         "object")
    return out


def _ndarray(data: bytes) -> np.ndarray:
    shape, name, buf = unpackb(data, raw=True)
    try:
        dtype = np.dtype(name.decode())
    except TypeError:            # bfloat16, which numpy does not know
        raise ValueError(f"msgpack: arrays of {name.decode()} are not "
                         "read") from None
    return np.frombuffer(buf, dtype=dtype).reshape(shape)


def _ext_value(code: int, data: bytes):
    if code == _EXT_NDARRAY:
        return _ndarray(data)
    if code == _EXT_NPSCALAR:
        return _ndarray(data)[()]
    raise ValueError(f"msgpack: unknown ext type {code}")


# ---------------------------------------------------------------------------
# files
# ---------------------------------------------------------------------------

def save_msgpack(variables: Any, path: str) -> None:
    """Write a variables tree (nested dicts of numpy arrays) as flax's
    `msgpack_serialize` writes it."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write(packb(variables, sort_keys=True))


def save_orbax(variables: Any, path: str) -> None:
    """Save a variables tree (numpy leaves) to an Orbax checkpoint
    directory, as the JAX package's `save_orbax`."""
    orbax.save(os.path.abspath(path), variables)


def load_orbax(path: str) -> Any:
    """An Orbax checkpoint directory as the tree the JAX package's
    `load_orbax` returns, with numpy leaves."""
    return orbax.load(os.path.abspath(path))


def load_msgpack(path: str) -> Any:
    """A file written by flax's `msgpack_serialize` (or `save_msgpack`) as
    nested dicts of numpy arrays.  A file that is not one whole msgpack
    object raises ValueError."""
    with open(path, "rb") as f:
        return unpackb(f.read())


TRAIN_KEYS = ("params", "batch_stats", "opt_state", "step")
TORCH_SUFFIXES = (".pth.tar", ".pth", ".tar", ".pt")


def optax_to_orbax(opt_state: dict) -> list:
    """An optax chain state in flax's msgpack layout ({'0': ..., '1': {},
    ...}, `models/convert.py::opt_state_to_flax`) as Orbax stores the same
    tuple of states: a list, None for an EmptyState."""
    return [opt_state[str(i)] or None for i in range(len(opt_state))]


def optax_from_orbax(opt_state) -> Any:
    """Orbax's optax chain state (a list, None for an EmptyState) in
    flax's msgpack layout; anything else is returned as it is, for the
    trainer's own check of its layout (`opt_state_from_flax`) to
    refuse."""
    if not isinstance(opt_state, list):
        return opt_state
    return {str(i): {} if v is None else v for i, v in enumerate(opt_state)}


def save_train_state(path: str, variables: dict, opt_state: dict,
                     step: int, fmt: str = "msgpack") -> None:
    """A trainer's epoch checkpoint: the Flax {'params', 'batch_stats'}
    of the prior, the optax state tree (flax's msgpack layout) and the
    step count (0-d int32), as a msgpack file or (`fmt` 'orbax') an Orbax
    directory with the optax state as Orbax stores it."""
    payload = {"params": variables["params"],
               "batch_stats": variables["batch_stats"],
               "opt_state": opt_state,
               "step": np.asarray(step, np.int32)}
    if fmt == "orbax":
        payload["opt_state"] = optax_to_orbax(opt_state)
        save_orbax(payload, path)
    else:
        save_msgpack(payload, path)


def load_train_state(path: str) -> dict:
    """A trainer's epoch checkpoint, a msgpack file or an Orbax directory,
    with the optax state in flax's msgpack layout; one of other keys
    raises ValueError (flax's `from_bytes` and orbax's `restore` into the
    trainer's target do the same in the JAX package)."""
    if os.path.isdir(path):
        blob = load_orbax(path)
        if isinstance(blob, dict) and "opt_state" in blob:
            blob["opt_state"] = optax_from_orbax(blob["opt_state"])
    else:
        blob = load_msgpack(path)
    if not isinstance(blob, dict) or set(blob) != set(TRAIN_KEYS):
        keys = sorted(blob) if isinstance(blob, dict) else type(blob)
        raise ValueError(f"{path}: not a training checkpoint of "
                         f"{list(TRAIN_KEYS)} (has {keys})")
    return blob


def load_prior_variables(path: str, seq_len: int = 10,
                         hidden_dims=(64, 64, 128, 256, 512)) -> Any:
    """A prior's Flax variables tree (numpy leaves, 'batch_stats' added
    empty where the file has none) from a torch file (by its suffix: the
    reference's .pth.tar training checkpoints or bare state dicts), an
    Orbax directory or a flax msgpack file (everything they hold, a
    training checkpoint's 'opt_state' and 'step' too).  The prior's
    seq_len and hidden_dims must be the given ones."""
    if path.endswith(TORCH_SUFFIXES):
        from globalegomocap_tpu_torch.cli.serve import load_state
        from globalegomocap_tpu_torch.models.convert import params_to_flax
        v = params_to_flax(load_state(path))
    elif os.path.isdir(path):
        v = load_orbax(path)
    else:
        v = load_msgpack(path)
    if not isinstance(v, dict) or "params" not in v:
        raise ValueError(f"checkpoint at {path} has no 'params'")
    v.setdefault("batch_stats", {})
    p = v["params"]
    hidden = tuple(np.shape(p[f"enc_{i}"]["conv"]["kernel"])[-1]
                   for i in range(sum(k.startswith("enc_") for k in p)))
    t = np.shape(p["fc_mu"]["kernel"])[0] // hidden[-1]
    if hidden != tuple(hidden_dims) or t != seq_len:
        raise ValueError(f"{path}: a prior of hidden dims {hidden} and "
                         f"seq_len {t}, not {tuple(hidden_dims)} and "
                         f"{seq_len}")
    return v
