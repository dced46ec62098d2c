"""HDF5 files without h5py: the reader of the NYUv2 and Hypersim
preparers (`prepare_dataset.py`).

    with File(path) as f:
        images = f["images"]              # a Dataset: .shape, .dtype
        frame = images[i]                 # reads only the chunks of frame i
        refs = f["sceneTypes"][0]         # object references
        name = f[refs[0]][:]              # the referenced dataset
        whole = np.asarray(f["depths"])

Shapes are in the stored dataspace order, as h5py gives them (for a
MATLAB file the reverse of MATLAB's own order). Values, dtypes (byte
order included) and shapes equal h5py's.

What is read is the format that MATLAB v7.3 and h5py's default
`libver='earliest'` write:
  - a user block before the superblock (signature at 0, 512, 1024, ...);
    every address is relative to the superblock's offset;
  - superblock versions 0 and 1;
  - version-1 object headers (messages 8-byte aligned, continuation
    blocks);
  - symbol-table groups: the v1 B-tree of type 0, the local heap and
    its `SNOD` nodes, at any depth;
  - dataspaces scalar and simple (message versions 1 and 2);
  - datatypes fixed-point of 1, 2, 4, 8 bytes, signed or not, IEEE
    float of 2, 4, 8 bytes, either byte order; object references;
    fixed-length strings;
  - fill value messages (the old one and versions 1-3): unallocated
    storage and chunks read as the fill value;
  - data layout message version 3: compact, contiguous, and chunked
    with the v1 B-tree of type 1 as the chunk index (edge chunks are
    stored whole and cropped here);
  - the filter pipeline (versions 1, 2): deflate, shuffle and
    fletcher32 (checked, then stripped), as each chunk's filter mask
    says.
Anything else that decides the data (superblock versions 2 and 3,
`OHDR` headers, link messages, layouts other than version 3, other
datatype classes or filters, shared messages, external files, soft
links) raises `NotPortedError` naming the structure; attributes and
other messages that do not change the data are skipped.

A dataset reads only the chunks that meet the selection; the file keeps
the most recently decoded chunks (at most `CHUNK_CACHE_BYTES`), so
consecutive frames that share a chunk inflate it once.
"""

from __future__ import annotations

import itertools
import os
import struct
import zlib
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

import numpy as np

from emsanet_tpu_torch.config import NotPortedError

SIGNATURE = b"\x89HDF\r\n\x1a\n"
CHUNK_CACHE_BYTES = 128 << 20

# message types
_DATASPACE, _LINK_INFO, _DATATYPE, _FILL_OLD, _FILL = 0x1, 0x2, 0x3, 0x4, 0x5
_LINK, _EXTERNAL, _LAYOUT, _FILTERS = 0x6, 0x7, 0x8, 0xB
_CONTINUATION, _SYMBOL_TABLE = 0x10, 0x11
_DECIDES_DATA = (_DATASPACE, _DATATYPE, _FILL_OLD, _FILL, _LAYOUT, _FILTERS)
_DEFLATE, _SHUFFLE, _FLETCHER32 = 1, 2, 3
_FILTER_NAMES = {4: "szip", 5: "nbit", 6: "scaleoffset", 307: "bzip2",
                 32000: "lzf", 32001: "blosc", 32004: "lz4", 32015: "zstd"}
# IEEE layouts by size: precision, exponent location and size, mantissa
# location and size, exponent bias
_IEEE = {2: (16, 10, 5, 0, 10, 15), 4: (32, 23, 8, 0, 23, 127),
         8: (64, 52, 11, 0, 52, 1023)}


class Reference:
    """An object reference: the address of an object's header."""

    __slots__ = ("address",)

    def __init__(self, address: int):
        self.address = address

    def __bool__(self) -> bool:
        return self.address != 0

    def __repr__(self) -> str:
        return f"<HDF5 object reference {self.address:#x}>"


class File:
    """A read-only HDF5 file; a context manager, indexed like h5py's."""

    def __init__(self, path: str):
        self.path = path
        self._fd = os.open(path, os.O_RDONLY)
        self._objects: Dict[int, object] = {}
        self._chunks: "OrderedDict[tuple, np.ndarray]" = OrderedDict()
        self._chunk_bytes = 0
        try:
            self._read_superblock()
        except BaseException:
            self.close()
            raise

    # -- the file's bytes ---------------------------------------------------
    def _read(self, address: int, n: int) -> bytes:
        data = os.pread(self._fd, n, self._base + address)
        if len(data) != n:
            raise ValueError(f"{self.path}: truncated HDF5 file ({n} bytes "
                             f"at {address:#x} asked, {len(data)} read)")
        return data

    def _unported(self, what: str) -> NotPortedError:
        return NotPortedError(f"not ported yet: {what} ({self.path})")

    def _uint(self, data: bytes, pos: int, size: int) -> int:
        return int.from_bytes(data[pos:pos + size], "little")

    def _defined(self, address: int) -> bool:
        return address != (1 << (8 * self._o)) - 1

    def _read_superblock(self) -> None:
        size = os.fstat(self._fd).st_size
        offset = 0
        while offset + len(SIGNATURE) <= size:
            if os.pread(self._fd, 8, offset) == SIGNATURE:
                break
            offset = 512 if offset == 0 else 2 * offset
        else:
            raise ValueError(f"{self.path} is not an HDF5 file")
        self._base = offset
        head = self._read(0, 24)
        version = head[8]
        if version in (2, 3):
            raise self._unported(f"HDF5 superblock version {version} (a file "
                                 "written with libver later than "
                                 "'earliest')")
        if version > 3:
            raise ValueError(f"{self.path}: unknown HDF5 superblock version "
                             f"{version}")
        self._o, self._l = head[13], head[14]
        if self._o not in (2, 4, 8) or self._l not in (2, 4, 8):
            raise ValueError(f"{self.path}: bad HDF5 offset / length sizes "
                             f"{self._o}, {self._l}")
        pos = 24 + (4 if version == 1 else 0)
        o = self._o
        tail = self._read(pos, 4 * o + 2 * o + 24)
        layout_block = self._uint(tail, 3 * o, o)
        if self._defined(layout_block):
            raise self._unported("HDF5 family, multi or split files (a "
                                 "superblock naming a file-layout block)")
        # the root group's symbol table entry: its object header address
        self.root = self._object(self._entry(tail, 4 * o))
        if not isinstance(self.root, Group):
            raise ValueError(f"{self.path}: the root object is no group")

    def _entry(self, data: bytes, pos: int) -> Optional[int]:
        """The object header address of a symbol table entry (None for a
        soft link)."""
        o = self._o
        if self._uint(data, pos + 2 * o, 4) == 2:
            return None
        return self._uint(data, pos + o, o)

    # -- object headers -------------------------------------------------------
    def _messages(self, address: int) -> List[Tuple[int, int, bytes]]:
        """(type, flags, data) of every message of a v1 object header."""
        head = self._read(address, 16)
        if head[:4] == b"OHDR":
            raise self._unported("HDF5 version-2 object headers (OHDR)")
        if head[0] != 1:
            raise ValueError(f"{self.path}: bad object header at "
                             f"{address:#x}")
        blocks = [(address + 16, self._uint(head, 8, 4))]
        out = []
        while blocks:
            start, length = blocks.pop(0)
            data = self._read(start, length)
            pos = 0
            while pos + 8 <= length:
                kind, size, flags = struct.unpack_from("<HHB", data, pos)
                body = data[pos + 8:pos + 8 + size]
                pos += 8 + size
                if kind == _CONTINUATION:
                    blocks.append((self._uint(body, 0, self._o),
                                   self._uint(body, self._o, self._l)))
                elif kind:
                    out.append((kind, flags, body))
        return out

    def _object(self, address: int):
        if address in self._objects:
            return self._objects[address]
        msgs = self._messages(address)
        kinds = {k for k, _, _ in msgs}
        for kind, flags, _ in msgs:
            if flags & 2 and kind in _DECIDES_DATA:
                raise self._unported(f"shared HDF5 messages (type {kind:#x})")
        if kinds & {_LINK_INFO, _LINK}:
            raise self._unported("HDF5 link messages (groups of the new "
                                 "format, or dense link storage)")
        if _LAYOUT in kinds:
            obj = Dataset(self, address, msgs)
        elif _SYMBOL_TABLE in kinds:
            obj = Group(self, msgs)
        elif _DATATYPE in kinds:
            raise self._unported("HDF5 committed (named) datatypes")
        else:
            raise ValueError(f"{self.path}: no dataset or group at "
                             f"{address:#x}")
        self._objects[address] = obj
        return obj

    # -- the chunk cache ------------------------------------------------------
    def _cached(self, key: tuple) -> Optional[np.ndarray]:
        chunk = self._chunks.get(key)
        if chunk is not None:
            self._chunks.move_to_end(key)
        return chunk

    def _cache(self, key: tuple, chunk: np.ndarray) -> None:
        self._chunks[key] = chunk
        self._chunk_bytes += chunk.nbytes
        while self._chunk_bytes > CHUNK_CACHE_BYTES and len(self._chunks) > 1:
            _, old = self._chunks.popitem(last=False)
            self._chunk_bytes -= old.nbytes

    # -- the interface --------------------------------------------------------
    def __getitem__(self, key):
        if isinstance(key, Reference):
            if not key:
                raise ValueError("a null HDF5 object reference")
            return self._object(key.address)
        return self.root[key]

    def __contains__(self, name: str) -> bool:
        return name in self.root

    def get(self, name: str, default=None):
        return self.root.get(name, default)

    def close(self) -> None:
        if self._fd >= 0:
            os.close(self._fd)
            self._fd = -1
        self._chunks.clear()

    def __enter__(self) -> "File":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class Group:
    """A symbol-table group: `g[path]`, `name in g`, `g.get`, `keys()`."""

    def __init__(self, file: File, msgs):
        self._file = file
        (body,) = [b for k, _, b in msgs if k == _SYMBOL_TABLE]
        o = file._o
        self._btree = file._uint(body, 0, o)
        self._heap = file._uint(body, o, o)
        self._members: Optional[Dict[str, Optional[int]]] = None

    def _load(self) -> Dict[str, Optional[int]]:
        if self._members is not None:
            return self._members
        f, o, l_ = self._file, self._file._o, self._file._l
        head = f._read(self._heap, 8 + 2 * l_ + o)
        if head[:4] != b"HEAP":
            raise ValueError(f"{f.path}: bad local heap at {self._heap:#x}")
        heap = f._read(f._uint(head, 8 + 2 * l_, o), f._uint(head, 8, l_))
        members: Dict[str, Optional[int]] = {}
        entry = 2 * o + 24
        for node in _btree_leaves(f, self._btree, 0, None):
            data = f._read(node, 8)
            if data[:4] != b"SNOD":
                raise ValueError(f"{f.path}: bad symbol table node at "
                                 f"{node:#x}")
            n = f._uint(data, 6, 2)
            table = f._read(node + 8, n * entry)
            for i in range(n):
                start = f._uint(table, i * entry, o)
                name = heap[start:heap.index(b"\0", start)].decode()
                members[name] = f._entry(table, i * entry)
        self._members = members
        return members

    def keys(self):
        return list(self._load())

    def __getitem__(self, path: str):
        obj = self
        for part in path.split("/"):
            if part in ("", "."):
                continue
            if not isinstance(obj, Group):
                raise KeyError(f"{path!r}: {part!r} is inside a dataset")
            members = obj._load()
            if part not in members:
                raise KeyError(f"object {path!r} doesn't exist")
            if members[part] is None:
                raise obj._file._unported(f"HDF5 soft links ({path!r})")
            obj = obj._file._object(members[part])
        return obj

    def __contains__(self, path: str) -> bool:
        try:
            self[path]
        except KeyError:
            return False
        return True

    def get(self, path: str, default=None):
        try:
            return self[path]
        except KeyError:
            return default


def _btree_leaves(f: File, address: int, node_type: int, key_size):
    """(key bytes, child address) of every level-0 entry of the v1 B-tree
    at `address` (type 0: groups; type 1: chunks, `key_size` bytes a
    key), or the child addresses alone for type 0."""
    o = f._o
    head = f._read(address, 8 + 2 * o)
    if head[:4] != b"TREE" or head[4] != node_type:
        raise ValueError(f"{f.path}: bad v1 B-tree node at {address:#x}")
    level, n = head[5], f._uint(head, 6, 2)
    key = f._l if node_type == 0 else key_size
    body = f._read(address + 8 + 2 * o, n * (key + o) + key)
    for i in range(n):
        pos = i * (key + o)
        child = f._uint(body, pos + key, o)
        if level:
            yield from _btree_leaves(f, child, node_type, key_size)
        elif node_type == 0:
            yield child
        else:
            yield body[pos:pos + key], child


class Dataset:
    """A dataset: `.shape`, `.dtype`, numpy-style reads of a box."""

    def __init__(self, file: File, address: int, msgs):
        self._file = file
        self.name = f"dataset at {address:#x}"
        self._key = address
        by_kind: Dict[int, bytes] = {}
        for kind, _, body in msgs:
            by_kind.setdefault(kind, body)
        if _EXTERNAL in by_kind:
            raise file._unported("HDF5 external data files")
        self.shape = self._dataspace(by_kind[_DATASPACE])
        self.dtype, self._raw = self._datatype(by_kind[_DATATYPE])
        self._fill = self._fill_value(by_kind.get(_FILL),
                                      by_kind.get(_FILL_OLD))
        self._filters = (self._pipeline(by_kind[_FILTERS])
                         if _FILTERS in by_kind else [])
        self._layout(by_kind[_LAYOUT])
        self._index: Optional[Dict[tuple, tuple]] = None

    # -- messages -------------------------------------------------------------
    def _dataspace(self, body: bytes) -> Tuple[int, ...]:
        f = self._file
        version, rank, flags = body[0], body[1], body[2]
        if version == 1:
            pos = 8
        elif version == 2:
            if body[3] == 2:
                raise f._unported("HDF5 null dataspaces")
            pos = 4
        else:
            raise f._unported(f"HDF5 dataspace message version {version}")
        del flags  # maximum sizes follow the sizes and do not matter here
        return tuple(f._uint(body, pos + i * f._l, f._l) for i in range(rank))

    def _datatype(self, body: bytes):
        """(the values' dtype, the stored dtype)."""
        f = self._file
        cls, bits = body[0] & 15, int.from_bytes(body[1:4], "little")
        size = f._uint(body, 4, 4)
        if cls == 0:  # fixed-point
            offset, precision = struct.unpack_from("<HH", body, 8)
            if size not in (1, 2, 4, 8) or offset or precision != 8 * size:
                raise f._unported(f"HDF5 integers of {precision} bits at "
                                  f"offset {offset} in {size} bytes")
            dt = np.dtype(f"{'>' if bits & 1 else '<'}"
                          f"{'i' if bits & 8 else 'u'}{size}")
            return dt, dt
        if cls == 1:  # floating-point
            layout = struct.unpack_from("<HHBBBBI", body, 8)
            if (bits & 0x40 or size not in _IEEE or layout[0] != 0
                    or layout[1:] != _IEEE[size]
                    or (bits >> 8) & 0xFF != 8 * size - 1):
                raise f._unported(f"HDF5 floats other than IEEE 754 of 2, 4 "
                                  f"or 8 bytes (size {size}, layout "
                                  f"{layout})")
            dt = np.dtype(f"{'>' if bits & 1 else '<'}f{size}")
            return dt, dt
        if cls == 3:  # fixed-length string
            dt = np.dtype(f"S{size}")
            return dt, dt
        if cls == 7:  # reference
            if bits & 15 != 0:
                raise f._unported("HDF5 region references")
            return np.dtype(object), np.dtype(f"<u{size}")
        names = {2: "time", 4: "bitfield", 5: "opaque", 6: "compound",
                 8: "enumeration", 9: "variable-length", 10: "array"}
        raise f._unported(f"HDF5 {names.get(cls, f'class {cls}')} "
                          f"datatypes")

    def _fill_value(self, new: Optional[bytes], old: Optional[bytes]):
        value = b""
        if new is not None:
            version = new[0]
            if version in (1, 2):
                if version == 1 or new[3]:
                    size = self._file._uint(new, 4, 4)
                    value = new[8:8 + size]
            elif version == 3:
                if new[1] & 0x20:
                    size = self._file._uint(new, 2, 4)
                    value = new[6:6 + size]
            else:
                raise self._file._unported(f"HDF5 fill value message "
                                           f"version {version}")
        elif old is not None:
            value = old[4:4 + self._file._uint(old, 0, 4)]
        if len(value) not in (0, self._raw.itemsize):
            raise ValueError(f"{self._file.path}: a fill value of "
                             f"{len(value)} bytes for {self._raw}")
        return value or bytes(self._raw.itemsize)

    def _pipeline(self, body: bytes) -> List[Tuple[int, tuple]]:
        """[(filter id, client data)] in the order they were applied."""
        f = self._file
        version, n = body[0], body[1]
        if version not in (1, 2):
            raise f._unported(f"HDF5 filter pipeline version {version}")
        pos = 8 if version == 1 else 2
        out = []
        for _ in range(n):
            fid = f._uint(body, pos, 2)
            pos += 2
            name_len = 0
            if version == 1 or fid >= 256:
                name_len = f._uint(body, pos, 2)
                pos += 2
            flags, n_data = struct.unpack_from("<HH", body, pos)
            pos += 4 + name_len
            data = struct.unpack_from(f"<{n_data}I", body, pos)
            pos += 4 * n_data + (4 if version == 1 and n_data % 2 else 0)
            if fid not in (_DEFLATE, _SHUFFLE, _FLETCHER32):
                raise f._unported(f"the HDF5 filter "
                                  f"{_FILTER_NAMES.get(fid, fid)}")
            del flags  # an optional filter that ran is undone all the same
            out.append((fid, data))
        return out

    def _layout(self, body: bytes) -> None:
        f, o = self._file, self._file._o
        version, cls = body[0], body[1]
        if version != 3:
            raise f._unported(f"HDF5 data layout message version {version}"
                              + (" (chunk indexes of the new format)"
                                 if version == 4 else ""))
        self._compact = self._address = self._chunk = None
        if cls == 0:
            size = f._uint(body, 2, 2)
            self._compact = body[4:4 + size]
        elif cls == 1:
            self._address = f._uint(body, 2, o)
        elif cls == 2:
            ndims = body[2]
            self._address = f._uint(body, 3, o)
            dims = struct.unpack_from(f"<{ndims}I", body, 3 + o)
            if dims[-1] != self._raw.itemsize or ndims - 1 != len(self.shape):
                raise ValueError(f"{f.path}: chunk dims {dims} for "
                                 f"{self.shape} {self._raw}")
            self._chunk = dims[:-1]
        else:
            raise f._unported("HDF5 virtual datasets")

    # -- reads ----------------------------------------------------------------
    def __array__(self, dtype=None, copy=None):
        out = np.asarray(self[()])
        return out if dtype is None else out.astype(dtype)

    def __getitem__(self, key):
        box, post = _selection(key, self.shape)
        arr = self._read_box(box)
        if self._raw != self.dtype:  # references
            refs = np.empty(arr.shape, object)
            refs.ravel()[:] = [Reference(int(a)) for a in arr.ravel()]
            arr = refs
        return arr[post]

    def _filled(self, shape) -> np.ndarray:
        fill = np.frombuffer(self._fill, self._raw)[0]
        return np.full(shape, fill, self._raw)

    def _read_box(self, box) -> np.ndarray:
        shape = tuple(hi - lo for lo, hi in box)
        if not self.shape:  # scalar
            if self._compact is not None:
                return np.frombuffer(self._compact, self._raw).reshape(())
            if self._chunk is None and self._file._defined(self._address):
                return np.frombuffer(self._file._read(
                    self._address, self._raw.itemsize), self._raw).reshape(())
            return self._filled(())
        if 0 in shape:
            return np.empty(shape, self._raw)
        if self._chunk is not None:
            return self._read_chunked(box, shape)
        if self._compact is not None:
            whole = np.frombuffer(self._compact, self._raw).reshape(
                self.shape)
            return whole[tuple(slice(lo, hi) for lo, hi in box)].copy()
        if not self._file._defined(self._address):
            return self._filled(shape)
        # contiguous: the rows of the first axis, then the rest of the box
        row = int(np.prod(self.shape[1:])) * self._raw.itemsize
        (lo, hi), rest = box[0], box[1:]
        data = self._file._read(self._address + lo * row, (hi - lo) * row)
        rows = np.frombuffer(data, self._raw).reshape(
            (hi - lo,) + self.shape[1:])
        return rows[(slice(None),) + tuple(slice(a, b) for a, b in rest)
                    ].copy()

    def _chunk_index(self) -> Dict[tuple, tuple]:
        if self._index is None:
            index = {}
            if self._file._defined(self._address):
                nd = len(self.shape) + 1
                for key, child in _btree_leaves(self._file, self._address, 1,
                                                8 + 8 * nd):
                    size, mask = struct.unpack_from("<II", key, 0)
                    offset = struct.unpack_from(f"<{nd}Q", key, 8)[:-1]
                    index[offset] = (child, size, mask)
            self._index = index
        return self._index

    def _read_chunked(self, box, shape) -> np.ndarray:
        out = np.empty(shape, self._raw)
        index = self._chunk_index()
        cd = self._chunk
        ranges = [range(lo // c, (hi - 1) // c + 1)
                  for (lo, hi), c in zip(box, cd)]
        for coords in itertools.product(*ranges):
            offset = tuple(i * c for i, c in zip(coords, cd))
            src, dst = [], []
            for (lo, hi), start, c in zip(box, offset, cd):
                a, b = max(lo, start), min(hi, start + c)
                src.append(slice(a - start, b - start))
                dst.append(slice(a - lo, b - lo))
            entry = index.get(offset)
            if entry is None:
                out[tuple(dst)] = np.frombuffer(self._fill, self._raw)[0]
                continue
            out[tuple(dst)] = self._decoded(offset, entry)[tuple(src)]
        return out

    def _decoded(self, offset: tuple, entry: tuple) -> np.ndarray:
        key = (self._key, offset)
        chunk = self._file._cached(key)
        if chunk is not None:
            return chunk
        address, size, mask = entry
        data = self._file._read(address, size)
        for i in reversed(range(len(self._filters))):
            if mask & (1 << i):
                continue
            fid, client = self._filters[i]
            if fid == _DEFLATE:
                data = zlib.decompress(data)
            elif fid == _SHUFFLE:
                data = _unshuffle(data, client[0] if client else
                                  self._raw.itemsize)
            else:
                data = self._fletcher32_stripped(data, offset)
        n = int(np.prod(self._chunk))
        if len(data) != n * self._raw.itemsize:
            raise ValueError(f"{self._file.path}: the chunk at {offset} of "
                             f"{self.name} holds {len(data)} bytes, "
                             f"{n * self._raw.itemsize} expected")
        chunk = np.frombuffer(data, self._raw).reshape(self._chunk)
        self._file._cache(key, chunk)
        return chunk

    def _fletcher32_stripped(self, data: bytes, offset: tuple) -> bytes:
        body, stored = data[:-4], int.from_bytes(data[-4:], "little")
        value = fletcher32(body)
        # HDF5 before 1.6.3 stored the two halves swapped
        swapped = ((value & 0xFFFF) << 16) | (value >> 16)
        if stored not in (value, swapped):
            raise ValueError(f"{self._file.path}: the fletcher32 checksum of "
                             f"the chunk at {offset} of {self.name} does not "
                             f"match")
        return body


def _unshuffle(data: bytes, size: int) -> bytes:
    """Undo HDF5's shuffle filter: byte planes back to elements."""
    n = len(data) // size
    if size <= 1 or n <= 1:
        return data
    planes = np.frombuffer(data, np.uint8, n * size).reshape(size, n)
    return planes.T.tobytes() + data[n * size:]


def fletcher32(data: bytes) -> int:
    """HDF5's Fletcher-32 (`H5_checksum_fletcher32`): big-endian 16-bit
    words, both sums folded every 360 words and at the end."""
    words = np.frombuffer(data[:len(data) & ~1], ">u2").astype(np.int64)
    sum1 = sum2 = 0
    for start in range(0, words.size, 360):
        block = words[start:start + 360]
        # sum2 gains each running value of sum1 within the block
        sum2 += block.size * sum1 + int(
            (block * np.arange(block.size, 0, -1)).sum())
        sum1 += int(block.sum())
        sum1 = (sum1 & 0xFFFF) + (sum1 >> 16)
        sum2 = (sum2 & 0xFFFF) + (sum2 >> 16)
    if len(data) % 2:
        sum1 += data[-1] << 8
        sum2 += sum1
        sum1 = (sum1 & 0xFFFF) + (sum1 >> 16)
        sum2 = (sum2 & 0xFFFF) + (sum2 >> 16)
    sum1 = (sum1 & 0xFFFF) + (sum1 >> 16)
    sum2 = (sum2 & 0xFFFF) + (sum2 >> 16)
    return (sum2 << 16) | sum1


def _selection(key, shape):
    """(the box to read: [(lo, hi)] per axis, the index into it) of a
    numpy-style key of ints, slices (step >= 1) and one Ellipsis."""
    if not isinstance(key, tuple):
        key = (key,)
    if sum(k is Ellipsis for k in key) > 1:
        raise IndexError("an index can only have a single ellipsis")
    if Ellipsis in key:
        i = key.index(Ellipsis)
        key = key[:i] + (slice(None),) * (len(shape) - len(key) + 1) \
            + key[i + 1:]
    if len(key) > len(shape):
        raise IndexError(f"{len(key)} indices for {len(shape)} dimensions")
    key = key + (slice(None),) * (len(shape) - len(key))
    box, post = [], []
    for k, n in zip(key, shape):
        if isinstance(k, slice):
            start, stop, step = k.indices(n)
            if step < 1:
                raise ValueError("a slice's step must be >= 1")
            stop = max(stop, start)
            box.append((start, stop))
            post.append(slice(None, None, step))
        else:
            i = int(k)
            if not -n <= i < n:
                raise IndexError(f"index {i} out of range for axis of "
                                 f"size {n}")
            i %= n
            box.append((i, i + 1))
            post.append(0)
    return box, tuple(post)
