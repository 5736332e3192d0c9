"""HDF5 files read and written without h5py: the subset that h5py writes
at its defaults, which holds the packed window corpora of
`data/hdf5.py`.

The file is a superblock, a root group and one object a dataset, every
address and length 8 bytes, little-endian:

- superblock version 0 (h5py's default; versions 2 and 3, which it
  writes at `libver='latest'`, are refused): the signature, the size of
  offsets and lengths, the group B-tree's K, the base and end-of-file
  addresses and the root group's symbol-table entry (96 bytes);
- a group: an object header whose symbol-table message names a v1
  B-tree (node type 0, keys are offsets of names in the group's local
  heap) whose leaves are symbol-table nodes (SNOD, at most 8 entries of
  a name offset and an object header address each);
- an object header, version 1: a 16-byte prefix, then 8-byte message
  headers (type, size, flags) each followed by its data, padded to 8
  bytes; a continuation message (type 0x10) points to more messages.
  A dataset's messages: dataspace (0x1, versions 1 and 2; a maximum of
  all ones is unlimited), datatype (0x3; IEEE float32 and float64,
  little-endian), fill value (0x4 old, 0x5 new), layout (0x8, version
  3: contiguous, or chunked with a v1 B-tree index) and filter pipeline
  (0xB, versions 1 and 2; deflate and shuffle); others are skipped;
- a chunk index: a v1 B-tree of node type 1 whose keys hold the chunk's
  stored size, its filter mask (a set bit i skips filter i) and rank + 1
  element offsets, the last of them the element dimension; a node holds
  at most 2K = 64 entries (K = 32 under superblock version 0) and is
  stored at that full size.  Each chunk is stored at the full chunk
  shape: an edge chunk is cropped at the extent, and a chunk missing
  inside it reads as the fill value.

`open(path)` indexes every dataset's chunks once, and `read(lo, hi)`
then costs one positioned read a chunk.  `create` and `append` write
HDF5Store's files: every dataset chunked in whole rows of at most
`CHUNK_BYTES`, its first dimension unlimited, float32 or float64, no
filter.  An append fills the last chunk in place, writes the new chunks
and a new chunk B-tree at the end of the file, and then rewrites the
dataspace's current size, the layout's B-tree address and the
superblock's end-of-file address in place; the old tree stays as
unreferenced space.  The bytes are not h5py's; h5py reads them to the
same arrays.
"""

from __future__ import annotations

import builtins
import itertools
import os
import struct
import zlib

import numpy as np

SIGNATURE = b"\x89HDF\r\n\x1a\n"
UNDEF = 0xFFFF_FFFF_FFFF_FFFF
# a chunk is at most this many bytes (h5py's default chunk cache), in a
# power-of-two number of whole rows: 512 rows of a (10, 15, 3) float32
# pose window are 921,600 B
CHUNK_BYTES = 1 << 20
CHUNK_K = 32                  # the chunk B-tree's K under superblock v0
GROUP_K, LEAF_K = 16, 4       # the group B-tree's and the SNODs' K
ENTRY = struct.Struct("<QQII16s")   # symbol-table entry, 40 bytes
NODE_HEAD = struct.Struct("<4sBBHQQ")
FLOATS = {(4, 32, 23, 8, 0, 23, 127): np.dtype("<f4"),
          (8, 64, 52, 11, 0, 52, 1023): np.dtype("<f8")}
TYPE_CLASSES = ("fixed-point", "floating-point", "time", "string",
                "bitfield", "opaque", "compound", "reference", "enumerated",
                "variable-length", "array")
FILTERS = {1: "deflate", 2: "shuffle", 3: "fletcher32", 4: "szip",
           5: "nbit", 6: "scaleoffset"}


def _pad8(n: int) -> int:
    return (n + 7) & ~7


def _write_all(fd: int, data, offset: int) -> None:
    view = memoryview(data).cast("B")
    while len(view):
        done = os.pwrite(fd, view, offset)
        view, offset = view[done:], offset + done


def _read_into(fd: int, buf, offset: int) -> None:
    """Fill the writable buffer `buf` from `offset` of `fd`."""
    view = memoryview(buf).cast("B")
    while len(view):
        got = os.preadv(fd, [view], offset)
        if got == 0:
            raise OSError(f"HDF5 file truncated at byte {offset}")
        view, offset = view[got:], offset + got


class Dataset:
    """One dataset of an open `File`: `shape`, `maxshape` (None where
    unlimited), `dtype`, `chunks` (None where contiguous), `fillvalue`;
    `read(lo, hi)` returns rows [lo, hi) as a numpy array."""

    def __init__(self, file: "File", name: str, messages: list):
        self.name = name
        self._file = file
        self._at = {}               # message type -> file offset of its data
        self.chunks = None
        self._addr = UNDEF
        self._filters = []
        fill = None
        for mtype, mflags, data, at in messages:
            self._at.setdefault(mtype, at)
            if mtype == 0x1:
                self.shape, self.maxshape = _dataspace(data)
            elif mtype == 0x3:
                if mflags & 0x2:
                    raise ValueError(f"{name}: a shared (committed) datatype")
                self.dtype = _datatype(name, data)
            elif mtype == 0x4 and fill is None:
                fill = data[4:4 + struct.unpack_from("<I", data)[0]]
            elif mtype == 0x5:
                fill = _fill_value(data)
            elif mtype == 0x7:
                raise ValueError(f"{name}: data in external files")
            elif mtype == 0x8:
                self._layout(name, data)
            elif mtype == 0xB:
                self._filters = _filter_pipeline(name, data)
        self.fillvalue = (np.frombuffer(fill, self.dtype)[0]
                          if fill and len(fill) == self.dtype.itemsize
                          else self.dtype.type(0))
        self._index = {}
        if self.chunks is not None and self._addr != UNDEF:
            self._index = file._chunk_index(self._addr, len(self.chunks) + 1,
                                            self.chunks)

    def _layout(self, name, data):
        if data[0] != 3:
            raise ValueError(f"{name}: layout message version {data[0]} "
                             "(this reader takes version 3)")
        if data[1] == 1:
            self._addr = struct.unpack_from("<Q", data, 2)[0]
        elif data[1] == 2:
            nd = data[2]
            self._addr = struct.unpack_from("<Q", data, 3)[0]
            self.chunks = struct.unpack_from(f"<{nd}I", data, 11)[:-1]
        else:
            raise ValueError(f"{name}: layout class {data[1]} (compact or "
                             "virtual; this reader takes contiguous and "
                             "chunked)")

    @property
    def _row_bytes(self) -> int:
        return int(np.prod(self.shape[1:], dtype=np.int64)) \
            * self.dtype.itemsize

    def read(self, lo: int = 0, hi: int | None = None) -> np.ndarray:
        """Rows [lo, hi) (clipped to the extent) as a new array."""
        if not self.shape:
            raise ValueError(f"{self.name}: a scalar dataset has no rows")
        n = self.shape[0]
        lo = min(max(lo, 0), n)
        hi = n if hi is None else min(max(hi, lo), n)
        out = np.empty((hi - lo,) + self.shape[1:], self.dtype)
        if not out.size:
            return out
        if self._addr == UNDEF:
            out.fill(self.fillvalue)
        elif self.chunks is None:
            _read_into(self._file.fd(), out,
                       self._addr + lo * self._row_bytes)
        else:
            self._read_chunks(out, lo, hi)
        return out

    def _read_chunks(self, out, lo, hi):
        c = self.chunks
        whole_rows = tuple(c[1:]) == self.shape[1:] and not self._filters
        grid = [range(lo // c[0], (hi - 1) // c[0] + 1)] + [
            range(-(-d // cd)) for d, cd in zip(self.shape[1:], c[1:])]
        for pos in itertools.product(*grid):
            first = [p * cd for p, cd in zip(pos, c)]
            r0, r1 = max(first[0], lo), min(first[0] + c[0], hi)
            dst = out[(slice(r0 - lo, r1 - lo),) + tuple(
                slice(f, f + cd) for f, cd in zip(first[1:], c[1:]))]
            entry = self._index.get(pos)
            if entry is None:
                dst[...] = self.fillvalue
            elif whole_rows:       # the rows straight into the slab
                _read_into(self._file.fd(), dst,
                           entry[0] + (r0 - first[0]) * self._row_bytes)
            else:
                chunk = self._chunk(*entry)
                dst[...] = chunk[(slice(r0 - first[0], r1 - first[0]),)
                                 + tuple(slice(0, s) for s in dst.shape[1:])]

    def _chunk(self, addr, nbytes, mask) -> np.ndarray:
        raw = self._file._read(addr, nbytes)
        for i, (fid, cd) in reversed(list(enumerate(self._filters))):
            if mask & (1 << i):
                continue
            if fid == 1:
                raw = zlib.decompress(raw)
            else:                  # shuffle: byte planes back to elements
                k = self.dtype.itemsize
                m = len(raw) // k
                raw = np.frombuffer(raw, np.uint8, m * k).reshape(
                    k, m).T.tobytes() + raw[m * k:]
        count = int(np.prod(self.chunks))
        if len(raw) != count * self.dtype.itemsize:
            raise ValueError(f"{self.name}: a chunk of {len(raw)} bytes, "
                             f"expected {count * self.dtype.itemsize}")
        return np.frombuffer(raw, self.dtype).reshape(self.chunks)


def _dataspace(data):
    version, rank, flags = data[0], data[1], data[2]
    if version == 1:
        pos = 8
    elif version == 2:
        pos = 4
    else:
        raise ValueError(f"dataspace message version {version}")
    dims = struct.unpack_from(f"<{rank}Q", data, pos)
    if not flags & 1:
        return dims, dims
    top = struct.unpack_from(f"<{rank}Q", data, pos + 8 * rank)
    return dims, tuple(None if m == UNDEF else m for m in top)


def _datatype(name, data):
    cls, bits = data[0] & 0x0F, data[1]
    size = struct.unpack_from("<I", data, 4)[0]
    if cls != 1:
        what = TYPE_CLASSES[cls] if cls < len(TYPE_CLASSES) else "unknown"
        raise ValueError(f"{name}: datatype class {cls} ({what}); this "
                         "reader takes IEEE float32 and float64")
    if bits & 1:
        raise ValueError(f"{name}: a big-endian float")
    props = struct.unpack_from("<HHBBBBI", data, 8)
    if props[0] != 0 or (size,) + props[1:] not in FLOATS:
        raise ValueError(f"{name}: a {8 * size}-bit float that is not IEEE "
                         "float32 or float64")
    return FLOATS[(size,) + props[1:]]


def _fill_value(data):
    version = data[0]
    if version in (1, 2):
        if version == 2 and not data[3]:
            return None
        size = struct.unpack_from("<I", data, 4)[0]
        return data[8:8 + size]
    if version == 3 and data[1] & 0x20:
        size = struct.unpack_from("<I", data, 2)[0]
        return data[6:6 + size]
    return None


def _filter_pipeline(name, data):
    version, n = data[0], data[1]
    pos = 8 if version == 1 else 2
    out = []
    for _ in range(n):
        fid = struct.unpack_from("<H", data, pos)[0]
        if version == 1 or fid >= 256:
            namelen = struct.unpack_from("<H", data, pos + 2)[0]
            pos += 4
        else:
            namelen = 0
            pos += 2
        ncd = struct.unpack_from("<H", data, pos + 2)[0]
        pos += 4 + (_pad8(namelen) if version == 1 else namelen)
        cd = struct.unpack_from(f"<{ncd}I", data, pos)
        pos += 4 * ncd + (4 if version == 1 and ncd % 2 else 0)
        if fid not in (1, 2):
            raise ValueError(f"{name}: filter id {fid} "
                             f"({FILTERS.get(fid, 'unknown')}); this reader "
                             "takes deflate (1) and shuffle (2)")
        out.append((fid, cd))
    return out


class File:
    """An HDF5 file open for reading: its root group's datasets by name,
    in name order (`f[name]`, `name in f`, `list(f)`)."""

    def __init__(self, path: str):
        self.path = path
        self._fd = os.open(path, os.O_RDONLY)
        try:
            self._datasets = self._root()
        except BaseException:
            os.close(self._fd)
            raise

    def _read(self, offset: int, n: int) -> bytes:
        data = os.pread(self.fd(), n, offset)
        if len(data) != n:
            raise OSError(f"{self.path}: truncated at byte "
                          f"{offset + len(data)}")
        return data

    def _root(self) -> dict:
        head = os.pread(self._fd, 96, 0)
        if head[:8] != SIGNATURE:
            raise OSError(f"{self.path} is not an HDF5 file (no HDF5 "
                          "signature at byte 0)")
        if len(head) < 96:
            raise OSError(f"{self.path}: truncated HDF5 superblock")
        if head[8] != 0:
            raise ValueError(
                f"{self.path}: HDF5 superblock version {head[8]}; this reader "
                "takes version 0, h5py's default (versions 2 and 3 come "
                "from libver='latest')")
        if head[13:15] != b"\x08\x08":
            raise ValueError(f"{self.path}: {head[13]}-byte offsets and "
                             f"{head[14]}-byte lengths (this reader takes 8)")
        if struct.unpack_from("<Q", head, 24)[0] != 0:
            raise ValueError(f"{self.path}: a user block (base address "
                             "not 0)")
        root = ENTRY.unpack_from(head, 56)[1]
        out = {}
        for mtype, _, data, _ in self._messages(root):
            if mtype == 0x11:
                btree, heap = struct.unpack_from("<QQ", data)
                names = self._heap(heap)
                for name_at, header in self._group_entries(btree):
                    name = names[name_at:names.index(b"\0", name_at)].decode()
                    messages = self._messages(header)
                    if any(m[0] == 0x8 for m in messages):
                        out[name] = Dataset(self, name, messages)
        return out

    def _messages(self, addr: int) -> list:
        """(type, flags, data, file offset of data) of an object header."""
        prefix = self._read(addr, 16)
        if prefix[:4] == b"OHDR":
            raise ValueError(f"{self.path}: object header version 2 (this "
                             "reader takes version 1)")
        if prefix[0] != 1:
            raise ValueError(f"{self.path}: object header version "
                             f"{prefix[0]}")
        count, size = struct.unpack_from("<H", prefix, 2)[0], \
            struct.unpack_from("<I", prefix, 8)[0]
        blocks, out = [(addr + 16, size)], []
        while blocks and len(out) < count:
            start, size = blocks.pop(0)
            raw, pos = self._read(start, size), 0
            while pos + 8 <= size and len(out) < count:
                mtype, msize, mflags = struct.unpack_from("<HHB", raw, pos)
                data = raw[pos + 8:pos + 8 + msize]
                if mtype == 0x10:
                    blocks.append(struct.unpack_from("<QQ", data))
                out.append((mtype, mflags, data, start + pos + 8))
                pos += 8 + msize
        return out

    def _heap(self, addr: int) -> bytes:
        sig, size, _, data = struct.unpack("<4s4xQQQ", self._read(addr, 32))
        if sig != b"HEAP":
            raise ValueError(f"{self.path}: no local heap at {addr}")
        return self._read(data, size)

    def _node(self, addr: int, kind: int, key_bytes: int):
        """A v1 B-tree node: (level, its entries' raw key+child bytes,
        entry count)."""
        sig, node_type, level, used, _, _ = NODE_HEAD.unpack(
            self._read(addr, NODE_HEAD.size))
        if sig != b"TREE" or node_type != kind:
            raise ValueError(f"{self.path}: no B-tree node of type {kind} "
                             f"at {addr}")
        body = self._read(addr + NODE_HEAD.size, used * (key_bytes + 8))
        return level, body, used

    def _group_entries(self, addr: int) -> list:
        """(name offset, object header) of a group, in B-tree order."""
        out, stack = [], [addr]
        while stack:
            level, body, used = self._node(stack.pop(), 0, 8)
            children = np.frombuffer(body, "<u8").reshape(used, 2)[:, 1]
            if level:
                stack.extend(int(a) for a in children[::-1])
                continue
            for snod in children:
                sig, _, count = struct.unpack("<4sBxH",
                                              self._read(int(snod), 8))
                if sig != b"SNOD":
                    raise ValueError(f"{self.path}: no SNOD at {snod}")
                raw = self._read(int(snod) + 8, count * ENTRY.size)
                out.extend(ENTRY.unpack_from(raw, i * ENTRY.size)[:2]
                           for i in range(count))
        return out

    def _chunk_index(self, addr: int, nd: int, chunks) -> dict:
        """Every chunk of a chunk B-tree, walked once at every level:
        grid position -> (address, stored bytes, filter mask)."""
        rec = np.dtype([("size", "<u4"), ("mask", "<u4"),
                        ("off", "<u8", (nd,)), ("child", "<u8")])
        index, stack = {}, [addr]
        while stack:
            level, body, used = self._node(stack.pop(), 1, rec.itemsize - 8)
            entries = np.frombuffer(body, rec, used)
            if level:
                stack.extend(int(a) for a in entries["child"])
                continue
            grid = entries["off"][:, :-1] // np.asarray(chunks, np.uint64)
            for g, child, size, mask in zip(grid.tolist(),
                                            entries["child"].tolist(),
                                            entries["size"].tolist(),
                                            entries["mask"].tolist()):
                index[tuple(g)] = (child, size, mask)
        return index

    def fd(self) -> int:
        if self._fd is None:
            raise ValueError(f"{self.path} is closed")
        return self._fd

    def __getitem__(self, name: str) -> Dataset:
        return self._datasets[name]

    def __contains__(self, name) -> bool:
        return name in self._datasets

    def __iter__(self):
        return iter(self._datasets)

    def __len__(self) -> int:
        return len(self._datasets)

    def close(self) -> None:
        if self._fd is not None:
            os.close(self._fd)
            self._fd = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def open(path: str) -> File:  # noqa: A001  (the module's reader)
    """Open an HDF5 file for reading (OSError where it is not HDF5,
    ValueError naming a feature this reader does not take)."""
    return File(path)


# ---------------------------------------------------------------------------
# the writer
# ---------------------------------------------------------------------------

def _chunk_rows(row_bytes: int) -> int:
    """Rows a chunk: the largest power of two whose rows fit in
    CHUNK_BYTES (one where a row alone is larger)."""
    rows = max(1, CHUNK_BYTES // max(row_bytes, 1))
    return 1 << (rows.bit_length() - 1)


def _message(mtype: int, data: bytes, flags: int = 0) -> bytes:
    data = data + bytes(_pad8(len(data)) - len(data))
    return struct.pack("<HHB3x", mtype, len(data), flags) + data


def _object_header(messages: list) -> bytes:
    body = b"".join(messages)
    return struct.pack("<BxHII4x", 1, len(messages), 1, len(body)) + body


def _dataset_header(shape: tuple, dtype: np.dtype) -> bytes:
    rank = 1 + len(shape)
    space = struct.pack(f"<BBB5x{2 * rank}Q", 1, rank, 1, 0, *shape, UNDEF,
                        *shape)
    size, *props = next(k for k, v in FLOATS.items() if v == dtype)
    ftype = struct.pack("<BBBBIHHBBBBI", 0x11, 0x20, 8 * size - 1, 0, size,
                        0, *props)
    fill = struct.pack("<BBBBI", 2, 3, 2, 1, 0)   # h5py's: 0, incremental
    layout = struct.pack(f"<BBBQ{rank + 1}I", 3, 2, rank + 1, UNDEF,
                         _chunk_rows(int(np.prod(shape, dtype=np.int64))
                                    * size), *shape, size)
    return _object_header([_message(0x1, space), _message(0x3, ftype, 1),
                           _message(0x5, fill, 1), _message(0x8, layout)])


def create(path: str, shapes: dict, dtype=np.float32) -> None:
    """A new file of empty datasets (0, *shape) of `dtype` (float32 or
    float64), each chunked in whole rows with its first dimension
    unlimited; an existing file at `path` is replaced."""
    dtype = np.dtype(dtype).newbyteorder("<")
    if dtype not in FLOATS.values():
        raise ValueError(f"dtype {dtype}: float32 or float64")
    names = sorted(shapes)          # a group's B-tree is searched by name
    for name in names:
        if not name or "/" in name or not all(int(d) > 0
                                              for d in shapes[name]):
            raise ValueError(f"dataset {name!r} of shape {shapes[name]}")
    snods = [names[i:i + 2 * LEAF_K] for i in range(0, len(names),
                                                    2 * LEAF_K)]
    if len(snods) > 2 * GROUP_K:
        raise ValueError(f"{len(names)} datasets: at most "
                         f"{4 * GROUP_K * LEAF_K}")
    # the root's local heap: "" at 0, then each name, 8-byte aligned
    heap, name_at = bytearray(8), {}
    for name in names:
        name_at[name] = len(heap)
        raw = name.encode() + b"\0"
        heap += raw + bytes(_pad8(len(raw)) - len(raw))
    root_header = 96
    btree = root_header + 40
    group_node = 24 + 2 * GROUP_K * 8 + (2 * GROUP_K + 1) * 8
    heap_at = btree + group_node
    snod_at = heap_at + 32 + len(heap)
    snod_bytes = 8 + 2 * LEAF_K * ENTRY.size
    headers = [_dataset_header(tuple(int(d) for d in shapes[n]), dtype)
               for n in names]
    header_at = list(itertools.accumulate(
        [snod_at + len(snods) * snod_bytes] + [len(h) for h in headers]))
    eof = header_at.pop()
    where = dict(zip(names, header_at))
    out = bytearray()
    out += SIGNATURE + struct.pack("<BBBBBBBBHHI", 0, 0, 0, 0, 0, 8, 8, 0,
                                   LEAF_K, GROUP_K, 0)
    out += struct.pack("<QQQQ", 0, UNDEF, eof, UNDEF)
    out += ENTRY.pack(0, root_header, 1, 0, struct.pack("<QQ", btree,
                                                        heap_at))
    out += _object_header([_message(0x11, struct.pack("<QQ", btree,
                                                      heap_at))])
    node = bytearray(group_node)
    NODE_HEAD.pack_into(node, 0, b"TREE", 0, 0, len(snods), UNDEF, UNDEF)
    keys = [0] + [name_at[s[-1]] for s in snods]
    for i, key in enumerate(keys):
        struct.pack_into("<Q", node, 24 + 16 * i, key)
        if i < len(snods):
            struct.pack_into("<Q", node, 32 + 16 * i, snod_at + i * snod_bytes)
    out += node
    out += struct.pack("<4s4xQQQ", b"HEAP", len(heap), 1, heap_at + 32) + heap
    for group in snods:
        snod = bytearray(snod_bytes)
        struct.pack_into("<4sBxH", snod, 0, b"SNOD", 1, len(group))
        for i, name in enumerate(group):
            ENTRY.pack_into(snod, 8 + i * ENTRY.size, name_at[name],
                            where[name], 0, 0, bytes(16))
        out += snod
    for h in headers:
        out += h
    with builtins.open(path, "wb") as f:
        f.write(out)


def _chunk_btree(at: int, keys: np.ndarray, children: np.ndarray,
                 bound: np.ndarray) -> tuple:
    """(bytes, root address) of a v1 chunk B-tree written from address
    `at` over `keys` (structured: size, mask, off) and the chunks'
    `children` addresses, in order; `bound` is the key past the last
    chunk.  Each node holds at most 2K entries and is stored at its full
    size; above the leaves a node's key i is child i's first key."""
    entry = np.dtype([("key", keys.dtype), ("child", "<u8")])
    node_bytes = NODE_HEAD.size + 2 * CHUNK_K * 8 + \
        (2 * CHUNK_K + 1) * keys.dtype.itemsize
    out, level = bytearray(), 0
    while True:
        n = len(keys)
        count = -(-n // (2 * CHUNK_K))
        addrs = at + node_bytes * np.arange(count, dtype=np.uint64)
        for j in range(count):
            lo, hi = 2 * CHUNK_K * j, min(2 * CHUNK_K * (j + 1), n)
            node = bytearray(node_bytes)
            NODE_HEAD.pack_into(
                node, 0, b"TREE", 1, level, hi - lo,
                int(addrs[j - 1]) if j else UNDEF,
                int(addrs[j + 1]) if j + 1 < count else UNDEF)
            rec = np.empty(hi - lo, entry)
            rec["key"], rec["child"] = keys[lo:hi], children[lo:hi]
            end = NODE_HEAD.size + rec.nbytes
            node[NODE_HEAD.size:end] = rec.tobytes()
            right = keys[hi] if hi < n else bound
            node[end:end + keys.dtype.itemsize] = right.tobytes()
            out += node
        at += count * node_bytes
        if count == 1:
            return bytes(out), int(addrs[0])
        keys, children = keys[::2 * CHUNK_K].copy(), addrs
        level += 1


def append(path: str, batches: dict) -> None:
    """Append rows to datasets of a file `create` wrote: `batches` maps a
    dataset's name to an array (n, *shape) of its row shape."""
    with open(path) as f:
        plans = []
        for name, values in batches.items():
            d = f[name]
            values = np.ascontiguousarray(values, dtype=d.dtype)
            if values.shape[1:] != d.shape[1:]:
                raise ValueError(f"{name}: rows of shape {values.shape[1:]}, "
                                 f"the dataset's are {d.shape[1:]}")
            grid = sorted(d._index)
            if d.chunks is None or tuple(d.chunks[1:]) != d.shape[1:] \
                    or d._filters or d.maxshape[0] is not None \
                    or grid != [(g,) + (0,) * (len(d.shape) - 1)
                                for g in range(len(grid))]:
                raise ValueError(f"{path}: {name} was not written by "
                                 "h5file.create")
            chunks = [d._index[g] for g in grid]
            plans.append((d, values, chunks))
        eof = os.fstat(f.fd()).st_size
    fd = os.open(path, os.O_RDWR)
    try:
        for d, values, chunks in plans:
            eof = _append_rows(fd, eof, d, values, chunks)
        os.pwrite(fd, struct.pack("<Q", eof), 40)
    finally:
        os.close(fd)


def _append_rows(fd, eof, d, values, chunks) -> int:
    """Write `values` after the dataset's rows and a new chunk B-tree;
    point the layout at it and set the dataspace's size.  Returns the new
    end of file."""
    n0, rows, row = d.shape[0], d.chunks[0], d._row_bytes
    if not len(values):
        return eof
    flat = values.reshape(len(values), -1).view(np.uint8)
    used = n0 % rows
    take = min(rows - used, len(values)) if used else 0
    if take:                      # the last chunk, filled in place
        _write_all(fd, flat[:take], chunks[-1][0] + used * row)
    rest = flat[take:]
    new = -(-len(rest) // rows)
    if new:
        block = np.zeros((new * rows, row), np.uint8)
        block[:len(rest)] = rest
        _write_all(fd, block, eof)
    addrs = np.asarray([c[0] for c in chunks] + [
        eof + i * rows * row for i in range(new)], np.uint64)
    eof += new * rows * row
    nd = len(d.shape) + 1
    kdt = np.dtype([("size", "<u4"), ("mask", "<u4"), ("off", "<u8", (nd,))])
    keys = np.zeros(len(addrs), kdt)
    keys["size"] = rows * row
    keys["off"][:, 0] = rows * np.arange(len(addrs), dtype=np.uint64)
    bound = np.zeros((), kdt)
    bound["off"][0] = rows * len(addrs)
    tree, root = _chunk_btree(eof, keys, addrs, bound)
    _write_all(fd, tree, eof)
    os.pwrite(fd, struct.pack("<Q", root), d._at[0x8] + 3)
    os.pwrite(fd, struct.pack("<Q", n0 + len(values)), d._at[0x1] + 8)
    return eof + len(tree)
