"""tensorstore's OCDBT key-value store, read and written without
tensorstore.

An Orbax checkpoint keeps its arrays in an OCDBT store ("Optionally-
Cooperative Distributed B+Tree") at the checkpoint's root: a manifest
(`manifest.ocdbt`) names the newest version's root b-tree node, the
nodes map keys to values, and values over `max_inline_value_bytes` sit in
data files (`d/<32 hex>`) as (file, offset, length) references.  Orbax
0.11 writes one store per process under `ocdbt.process_0/` and then a
root store whose nodes refer into it by paths relative to the root.

Manifest and node files share an envelope:

    magic           u32 big-endian (0x0cdb3a2a manifest, 0x0cdb20de node)
    length          u64 little-endian, the whole file's
    version         varint (0)
    compression     varint (0 none, 1 zstd)
    body            (zstd-compressed where compression is 1)
    crc32c          u32 little-endian, CRC-32C (Castagnoli) of every
                    byte before it

Inside the bodies every integer is a LEB128 varint unless stated, and
tables are stored column by column:

- a data file table: the number of files, then per file after the first
  the length of the path prefix shared with the previous file, per file
  the length of the rest and the length of its base path, then the
  rests.  A node's paths are relative to the base path of the file the
  node was read from;
- a manifest: the config (16-byte uuid, manifest kind, max inline value
  bytes, max decoded node bytes, u8 log2 of the version tree's arity,
  compression method and for zstd an i32 level), a data file table, the
  newest versions inline (their number, then columns of generation,
  u8 root height, root file, offset and length, the tree's key count,
  node bytes and indirect value bytes, and u64 commit times), and the
  number of version tree nodes for older versions;
- a b-tree node: its u8 height, a data file table, the entry count, the
  key column (prefix lengths shared with the previous key, suffix
  lengths, the suffixes), then for a leaf the value lengths, u8 value
  kinds (0 inline, 1 a reference) and for the references their file and
  offset columns, then the inline values; for an interior node the
  subtree common prefix lengths (a child's keys drop that much of its
  entry's key) after the suffix lengths, then columns of the children's
  file, offset, length, key count, node bytes and indirect value bytes.

`read_store` reads the newest version; `write_store` writes a store of
one version and one leaf node whose large values go to one data file,
which tensorstore (and so Orbax) reads.  CRC-32C is a table in Python: it
covers manifests and nodes, never the data files, which carry none.
"""

from __future__ import annotations

import os
import struct
import time
import uuid
from dataclasses import dataclass

import numpy as np

from globalegomocap_tpu_torch.native import zstd

MANIFEST_MAGIC = 0x0CDB3A2A
NODE_MAGIC = 0x0CDB20DE
MANIFEST = "manifest.ocdbt"
# tensorstore's defaults, which Orbax's stores carry in their config
MAX_INLINE_VALUE_BYTES = 1024
MAX_DECODED_NODE_BYTES = 100_000_000
VERSION_TREE_ARITY_LOG2 = 4
_NO_ROOT = (1 << 64) - 1


# ---------------------------------------------------------------------------
# CRC-32C (Castagnoli), reflected polynomial 0x82f63b78
# ---------------------------------------------------------------------------

def _crc_table() -> list:
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ (0x82F63B78 if c & 1 else 0)
        table.append(c)
    return table


_CRC_TABLE = _crc_table()


def crc32c(data, crc: int = 0) -> int:
    """CRC-32C of `data`, continuing from `crc`."""
    t = _CRC_TABLE
    c = crc ^ 0xFFFFFFFF
    for b in bytes(data):
        c = t[(c ^ b) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


# ---------------------------------------------------------------------------
# varints and the envelope
# ---------------------------------------------------------------------------

class _Reader:
    def __init__(self, data: bytes, where: str):
        self.data = data
        self.pos = 0
        self.where = where

    def fail(self, what: str):
        raise ValueError(f"ocdbt: {self.where}: {what} at byte {self.pos}")

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            self.fail(f"{n} bytes past the end")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def u8(self) -> int:
        return self.take(1)[0]

    def varint(self) -> int:
        v = shift = 0
        while True:
            b = self.u8()
            v |= (b & 0x7F) << shift
            if b < 0x80:
                return v
            shift += 7
            if shift > 63:
                self.fail("a varint longer than 64 bits")

    def varints(self, n: int) -> list:
        return [self.varint() for _ in range(n)]

    def end(self) -> None:
        if self.pos != len(self.data):
            self.fail(f"{len(self.data) - self.pos} bytes left over")


def _varint(v: int) -> bytes:
    out = bytearray()
    while v >= 0x80:
        out.append((v & 0x7F) | 0x80)
        v >>= 7
    out.append(v)
    return bytes(out)


def _varints(vs) -> bytes:
    return b"".join(_varint(v) for v in vs)


def decode_envelope(raw: bytes, magic: int, where: str) -> bytes:
    """The body of a manifest or node file, its magic, length and
    checksum checked; ValueError names `where` on any mismatch."""
    if len(raw) < 18:
        raise ValueError(f"ocdbt: {where}: {len(raw)} bytes is too short "
                         "for a manifest or node")
    got_magic, length = struct.unpack(">I", raw[:4])[0], \
        struct.unpack("<Q", raw[4:12])[0]
    if got_magic != magic:
        raise ValueError(f"ocdbt: {where}: magic 0x{got_magic:08x}, "
                         f"0x{magic:08x} expected")
    if length != len(raw):
        raise ValueError(f"ocdbt: {where}: the header says {length} bytes, "
                         f"the file has {len(raw)}")
    want = struct.unpack("<I", raw[-4:])[0]
    got = crc32c(raw[:-4])
    if got != want:
        raise ValueError(f"ocdbt: {where}: CRC-32C checksum mismatch "
                         f"(stored 0x{want:08x}, computed 0x{got:08x})")
    r = _Reader(raw[:-4], where)
    r.pos = 12
    if r.varint() != 0:
        r.fail("an unknown format version")
    compression = r.varint()
    body = raw[r.pos:-4]
    if compression == 0:
        return body
    if compression == 1:
        return zstd.decompress(body, limit=MAX_DECODED_NODE_BYTES)
    r.fail(f"unknown compression {compression}")


def encode_envelope(body: bytes, magic: int) -> bytes:
    """A manifest or node file of `body`, zstd-compressed as tensorstore
    writes them (its default level)."""
    comp = bytes(zstd.compress(body, level=0))
    head = struct.pack(">I", magic)
    rest = _varint(0) + _varint(1) + comp
    raw = head + struct.pack("<Q", 4 + 8 + len(rest) + 4) + rest
    return raw + struct.pack("<I", crc32c(raw))


# ---------------------------------------------------------------------------
# reading
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Ref:
    """A value (or node) stored out of line: `length` bytes at `offset` of
    the data file `path`, relative to the store's root."""
    path: str
    offset: int
    length: int


def _data_files(r: _Reader, base: str) -> list:
    """A data file table as [(base path, full path)], each under `base`."""
    n = r.varint()
    prefix = [0] + r.varints(max(n - 1, 0))
    suffix = r.varints(n)
    base_len = r.varints(n)
    files, prev = [], b""
    for i in range(n):
        full = prev[:prefix[i]] + r.take(suffix[i])
        if base_len[i] > len(full):
            r.fail("a base path longer than its path")
        files.append((base + full[:base_len[i]].decode(),
                      base + full.decode()))
        prev = full
    return files


def _keys(r: _Reader, n: int, interior: bool):
    prefix = [0] + r.varints(max(n - 1, 0))
    suffix = r.varints(n)
    common = r.varints(n) if interior else [0] * n
    keys, prev = [], b""
    for i in range(n):
        if prefix[i] > len(prev):
            r.fail("a key prefix longer than the previous key")
        prev = prev[:prefix[i]] + r.take(suffix[i])
        keys.append(prev)
    return keys, common


def _read_range(root: str, ref: Ref) -> bytes:
    with open(os.path.join(root, ref.path), "rb") as f:
        f.seek(ref.offset)
        data = f.read(ref.length)
    if len(data) != ref.length:
        raise ValueError(f"ocdbt: {ref.path}: {ref.length} bytes at "
                         f"{ref.offset} run past the end of the file")
    return data


def _read_manifest(root: str):
    """(config dict, the newest version's root: (Ref, height) or None)."""
    path = os.path.join(root, MANIFEST)
    if not os.path.exists(path):
        raise FileNotFoundError(f"ocdbt: {root} holds no {MANIFEST}: not an "
                                "OCDBT store (an Orbax checkpoint has one "
                                "at its root)")
    with open(path, "rb") as f:
        body = decode_envelope(f.read(), MANIFEST_MAGIC, path)
    r = _Reader(body, path)
    cfg = {"uuid": r.take(16), "manifest_kind": r.varint(),
           "max_inline_value_bytes": r.varint(),
           "max_decoded_node_bytes": r.varint(),
           "version_tree_arity_log2": r.u8(),
           "compression": r.varint()}
    if cfg["compression"] == 1:
        cfg["zstd_level"] = struct.unpack("<i", r.take(4))[0]
    if cfg["manifest_kind"] != 0:
        r.fail("a numbered manifest (only the single-file kind Orbax "
               "writes is read)")
    files = _data_files(r, "")
    n = r.varint()
    if n == 0:
        return cfg, None
    gen = r.varints(n)
    height = [r.u8() for _ in range(n)]
    file_id, offset, length = r.varints(n), r.varints(n), r.varints(n)
    r.varints(3 * n)            # keys, node bytes, indirect bytes
    r.take(8 * n)               # commit times
    # the newest versions are inline, oldest first; the version tree
    # nodes that follow hold only older ones
    newest = max(range(n), key=gen.__getitem__)
    if offset[newest] == _NO_ROOT:
        return cfg, None
    if file_id[newest] >= len(files):
        r.fail(f"data file {file_id[newest]} of {len(files)}")
    base, full = files[file_id[newest]]
    return cfg, (Ref(full, offset[newest], length[newest]), height[newest],
                 base)


def _read_node(root: str, ref: Ref, base: str, prefix: bytes, height: int,
               out: dict) -> None:
    where = f"node at {ref.offset} of {ref.path}"
    body = decode_envelope(_read_range(root, ref), NODE_MAGIC,
                           os.path.join(root, where))
    r = _Reader(body, os.path.join(root, where))
    if r.u8() != height:
        r.fail(f"a node of another height than its parent's {height}")
    files = _data_files(r, base)
    n = r.varint()
    keys, common = _keys(r, n, height > 0)

    def file_of(i):
        if i >= len(files):
            r.fail(f"data file {i} of {len(files)}")
        return files[i]
    if height > 0:
        cols = [r.varints(n) for _ in range(6)]
        r.end()
        for i in range(n):
            child_base, path = file_of(cols[0][i])
            _read_node(root, Ref(path, cols[1][i], cols[2][i]), child_base,
                       prefix + keys[i][:common[i]], height - 1, out)
        return
    lengths = r.varints(n)
    kinds = [r.u8() for _ in range(n)]
    if any(k > 1 for k in kinds):
        r.fail("an unknown value kind")
    indirect = [i for i in range(n) if kinds[i] == 1]
    ids, offs = r.varints(len(indirect)), r.varints(len(indirect))
    for i, fid, off in zip(indirect, ids, offs):
        out[(prefix + keys[i]).decode()] = Ref(file_of(fid)[1], off,
                                               lengths[i])
    for i in range(n):
        if kinds[i] == 0:
            out[(prefix + keys[i]).decode()] = r.take(lengths[i])
    r.end()


def read_store(root: str) -> dict:
    """The newest version of the OCDBT store at `root`: key -> the value's
    bytes where inline, a `Ref` into a data file where not.  Every
    manifest and node read has its checksum checked."""
    _, top = _read_manifest(root)
    out: dict = {}
    if top is not None:
        ref, height, base = top
        _read_node(root, ref, base, b"", height, out)
    return out


def read_value(root: str, value) -> bytes:
    """The bytes of a value of `read_store`."""
    return _read_range(root, value) if isinstance(value, Ref) else value


def read_value_into(root: str, value, out: np.ndarray) -> None:
    """The bytes of a value read straight into the uint8 array `out` of
    its length."""
    if not isinstance(value, Ref):
        out[...] = np.frombuffer(value, np.uint8)
        return
    with open(os.path.join(root, value.path), "rb") as f:
        f.seek(value.offset)
        n = f.readinto(memoryview(out))
    if n != value.length:
        raise ValueError(f"ocdbt: {value.path}: {value.length} bytes at "
                         f"{value.offset} run past the end of the file")


# ---------------------------------------------------------------------------
# writing
# ---------------------------------------------------------------------------

def _data_file_table(paths: list) -> bytes:
    raw = [p.encode() for p in paths]
    prefix = []
    for a, b in zip(raw, raw[1:]):
        n = 0
        while n < min(len(a), len(b)) and a[n] == b[n]:
            n += 1
        prefix.append(n)
    suffix = [len(p) - s for p, s in zip(raw, [0] + prefix)]
    return (_varint(len(raw)) + _varints(prefix) + _varints(suffix)
            + _varints([0] * len(raw))
            + b"".join(p[s:] for p, s in zip(raw, [0] + prefix)))


def _key_columns(keys: list) -> bytes:
    prefix = []
    for a, b in zip(keys, keys[1:]):
        n = 0
        while n < min(len(a), len(b)) and a[n] == b[n]:
            n += 1
        prefix.append(n)
    starts = [0] + prefix
    return (_varints(prefix) + _varints(len(k) - s
                                        for k, s in zip(keys, starts))
            + b"".join(k[s:] for k, s in zip(keys, starts)))


def write_store(root: str, values) -> None:
    """Write an OCDBT store of one version at `root` (a directory that
    holds no store yet): `values` yields (key, buffer) pairs, each buffer
    bytes or a C-contiguous uint8 array.  Values over
    MAX_INLINE_VALUE_BYTES are appended to one data file as they come
    (written from the buffer, not copied), the rest go inline into one
    leaf node, which closes the data file; a manifest of one generation
    names it."""
    if os.path.exists(os.path.join(root, MANIFEST)):
        raise FileExistsError(f"ocdbt: {root} already holds a store")
    os.makedirs(os.path.join(root, "d"), exist_ok=True)
    rel = f"d/{uuid.uuid4().hex}"
    entries = {}
    indirect_bytes = 0
    with open(os.path.join(root, rel), "wb") as f:
        offset = 0
        for key, buf in values:
            k = key.encode()
            if k in entries:
                raise ValueError(f"ocdbt: the key {key!r} twice")
            n = len(buf) if isinstance(buf, (bytes, bytearray)) \
                else memoryview(buf).nbytes
            if n > MAX_INLINE_VALUE_BYTES:
                f.write(buf)
                entries[k] = (n, offset)
                offset += n
                indirect_bytes += n
            else:
                entries[k] = (n, bytes(buf))
        keys = sorted(entries)
        lengths = [entries[k][0] for k in keys]
        kinds = [0 if isinstance(entries[k][1], bytes) else 1 for k in keys]
        body = (b"\x00" + _data_file_table([rel]) + _varint(len(keys))
                + _key_columns(keys) + _varints(lengths) + bytes(kinds)
                + _varints(0 for k in kinds if k)
                + _varints(entries[k][1] for k, kind in zip(keys, kinds)
                           if kind)
                + b"".join(entries[k][1] for k, kind in zip(keys, kinds)
                           if not kind))
        node = encode_envelope(body, NODE_MAGIC)
        f.write(node)
        node_offset = offset
    body = (uuid.uuid4().bytes + _varint(0)
            + _varint(MAX_INLINE_VALUE_BYTES)
            + _varint(MAX_DECODED_NODE_BYTES)
            + bytes([VERSION_TREE_ARITY_LOG2]) + _varint(1)
            + struct.pack("<i", 0)
            + _data_file_table([rel])
            + _varint(1) + _varint(1) + b"\x00" + _varint(0)
            + _varint(node_offset) + _varint(len(node))
            + _varint(len(keys)) + _varint(len(node))
            + _varint(indirect_bytes)
            + struct.pack("<Q", time.time_ns()) + _varint(0))
    with open(os.path.join(root, MANIFEST), "wb") as f:
        f.write(encode_envelope(body, MANIFEST_MAGIC))
