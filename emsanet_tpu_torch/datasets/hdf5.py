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

What is read is what MATLAB v7.3 and h5py write, at every `libver`
from 'earliest' to 'latest':
  - a user block before the superblock (signature at 0, 512, 1024, ...);
    every address is relative to the superblock's offset;
  - superblock versions 0 to 3 (2 and 3 with their lookup3 checksum;
    the superblock extension's messages are read);
  - object headers of version 1 (messages 8-byte aligned, continuation
    blocks) and version 2 (`OHDR` and `OCHK` blocks, checksums, the
    optional times, attribute phase and creation order fields);
  - symbol-table groups (the v1 B-tree of type 0, the local heap and its
    `SNOD` nodes, at any depth) and new-style groups: link messages in
    the header (compact) or in a fractal heap indexed by a v2 B-tree of
    type 5 (dense; `hdf5_index.py`); hard links, and soft links resolved
    as h5py resolves them;
  - dataspaces scalar and simple (message versions 1 and 2);
  - datatypes fixed-point of 1, 2, 4, 8 bytes, signed or not, of any
    precision and offset (as HDF5 converts them to the native type),
    IEEE float of 2, 4, 8 bytes, either byte order; object references;
    fixed-length strings;
  - fill value messages (the old one and versions 1-3): unallocated
    storage and chunks read as the fill value;
  - data layout messages version 3 (compact, contiguous, chunked with a
    v1 B-tree of type 1 as the chunk index) and version 4 (the chunk
    indexes single chunk, implicit, fixed array, extensible array and
    v2 B-tree of types 10 / 11; `hdf5_index.py`); edge chunks are stored
    whole and cropped here;
  - the filter pipeline (versions 1, 2): deflate, shuffle, fletcher32
    (checked, then stripped), nbit and scaleoffset (numpy),
    and h5py's lzf (the host library, `native.lzf_decompress`), as each
    chunk's filter mask says.
Anything else that decides the data (szip and other filters, external
data files and external links, shared messages, virtual datasets,
compound, variable-length, enumeration and other
datatype classes) raises `NotPortedError` naming the structure;
attributes and other messages that do not change the data are skipped.

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
from emsanet_tpu_torch.datasets import hdf5_index as index

SIGNATURE = b"\x89HDF\r\n\x1a\n"
CHUNK_CACHE_BYTES = 128 << 20
MAX_SOFT_LINKS = 16  # HDF5's H5L_NUM_LINKS: soft links one lookup follows

# message types
_DATASPACE, _LINK_INFO, _DATATYPE, _FILL_OLD, _FILL = 0x1, 0x2, 0x3, 0x4, 0x5
_LINK, _EXTERNAL, _LAYOUT, _FILTERS = 0x6, 0x7, 0x8, 0xB
_CONTINUATION, _SYMBOL_TABLE, _DRIVER_INFO = 0x10, 0x11, 0x14
_DECIDES_DATA = (_DATASPACE, _DATATYPE, _FILL_OLD, _FILL, _LAYOUT, _FILTERS)
_DEFLATE, _SHUFFLE, _FLETCHER32, _NBIT, _SCALEOFFSET = 1, 2, 3, 5, 6
_LZF = 32000
_FILTERS_READ = (_DEFLATE, _SHUFFLE, _FLETCHER32, _NBIT, _SCALEOFFSET, _LZF)
_FILTER_NAMES = {4: "szip", 307: "bzip2", 32001: "blosc", 32004: "lz4",
                 32015: "zstd"}
_LINK_KINDS = {0: "hard", 1: "soft", 64: "external"}
# chunk indexes of layout message version 4
_SINGLE, _IMPLICIT, _FIXED_ARRAY, _EXTENSIBLE_ARRAY, _BTREE2 = 1, 2, 3, 4, 5
_BTREE1 = 0  # layout version 3's
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
        if version > 3:
            raise ValueError(f"{self.path}: unknown HDF5 superblock version "
                             f"{version}")
        self._o, self._l = head[9:11] if version >= 2 else head[13:15]
        if self._o not in (2, 4, 8) or self._l not in (2, 4, 8):
            raise ValueError(f"{self.path}: bad HDF5 offset / length sizes "
                             f"{self._o}, {self._l}")
        o = self._o
        if version >= 2:
            data = index.checked(self, 0, self._read(0, 12 + 4 * o + 4),
                                 "superblock")
            extension, root = self._uint(data, 12 + o, o), self._uint(
                data, 12 + 3 * o, o)
            if self._defined(extension) and any(
                    k == _DRIVER_INFO for k, _, _ in self._messages(
                        extension)):
                raise self._unported("HDF5 family, multi or split files (a "
                                     "driver info message)")
        else:
            pos = 24 + (4 if version == 1 else 0)
            tail = self._read(pos, 4 * o + 2 * o + 24)
            if self._defined(self._uint(tail, 3 * o, o)):
                raise self._unported("HDF5 family, multi or split files (a "
                                     "superblock naming a file-layout "
                                     "block)")
            # the root group's symbol table entry: its object header
            root = self._entry(tail, 4 * o)[1]
        self.root = self._object(root)
        if not isinstance(self.root, Group):
            raise ValueError(f"{self.path}: the root object is no group")

    def _entry(self, data: bytes, pos: int, heap: bytes = b""):
        """A symbol table entry as a link: ("hard", object header
        address, None), or ("soft", its value in the local heap `heap`,
        None)."""
        o = self._o
        if self._uint(data, pos + 2 * o, 4) == 2:
            at = self._uint(data, pos + 2 * o + 8, 4)
            return "soft", heap[at:heap.index(b"\0", at)].decode(), None
        return "hard", self._uint(data, pos + o, o), None

    def _link(self, body: bytes):
        """(name, (kind, target, creation order)) of a link message."""
        if body[0] != 1:
            raise ValueError(f"{self.path}: link message version {body[0]}")
        flags, pos, kind, order = body[1], 2, 0, None
        if flags & 8:
            kind, pos = body[pos], pos + 1
        if flags & 4:
            order, pos = self._uint(body, pos, 8), pos + 8
        if flags & 16:
            pos += 1  # the name's character set
        width = 1 << (flags & 3)
        n = self._uint(body, pos, width)
        pos += width
        name = body[pos:pos + n].decode()
        pos += n
        if kind == 0:
            target = self._uint(body, pos, self._o)
        elif kind == 1:
            target = body[pos + 2:pos + 2 + self._uint(body, pos, 2)].decode()
        else:
            target = None
        return name, (_LINK_KINDS.get(kind, f"user-defined ({kind})"),
                      target, order)

    # -- object headers -------------------------------------------------------
    def _messages(self, address: int) -> List[Tuple[int, int, bytes]]:
        """(type, flags, data) of every message of an object header."""
        head = self._read(address, 16)
        if head[:4] == b"OHDR":
            return self._messages_v2(address, head)
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

    def _messages_v2(self, address: int, head: bytes):
        """The messages of a version-2 object header: its `OHDR` block
        and the `OCHK` blocks its continuation messages name, each
        checksummed; messages carry a creation order where the header's
        flags say so, and a gap smaller than a message header ends a
        block."""
        if head[4] != 2:
            raise ValueError(f"{self.path}: OHDR version {head[4]} at "
                             f"{address:#x}")
        flags = head[5]
        pos = 6 + (16 if flags & 0x20 else 0) + (4 if flags & 0x10 else 0)
        width = 1 << (flags & 3)
        first = self._read(address, pos + width)
        blocks = [(address, pos + width + self._uint(first, pos, width) + 4,
                   pos + width)]
        header = 4 + (2 if flags & 0x04 else 0)
        out = []
        while blocks:
            start, length, pos = blocks.pop(0)
            data = index.checked(self, start, self._read(start, length),
                                 "object header")
            if pos == 4 and data[:4] != b"OCHK":
                raise ValueError(f"{self.path}: bad object header "
                                 f"continuation block at {start:#x}")
            while pos + header <= len(data):
                kind, size, mflags = data[pos], self._uint(data, pos + 1,
                                                           2), data[pos + 3]
                body = data[pos + header:pos + header + size]
                pos += header + size
                if kind == _CONTINUATION:
                    blocks.append((self._uint(body, 0, self._o),
                                   self._uint(body, self._o, self._l), 4))
                elif kind:
                    out.append((kind, mflags, body))
        return out

    def _object(self, address: int):
        if address in self._objects:
            return self._objects[address]
        msgs = self._messages(address)
        kinds = {k for k, _, _ in msgs}
        for kind, flags, _ in msgs:
            if flags & 2 and kind in _DECIDES_DATA:
                raise self._unported(f"shared HDF5 messages (type {kind:#x})")
        if _LAYOUT in kinds:
            obj = Dataset(self, address, msgs)
        elif kinds & {_SYMBOL_TABLE, _LINK_INFO, _LINK}:
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
    """A group: `g[path]`, `name in g`, `g.get`, `keys()` (in h5py's
    order: by name, or by creation order where the group tracks it)."""

    def __init__(self, file: File, msgs):
        self._file = file
        self._msgs = msgs
        tables = [b for k, _, b in msgs if k == _SYMBOL_TABLE]
        # a symbol-table group's v1 B-tree and local heap
        self._btree, self._heap = ((file._uint(tables[0], 0, file._o),
                                    file._uint(tables[0], file._o, file._o))
                                   if tables else (None, None))
        self._members: Optional[Dict[str, tuple]] = None

    def _load(self) -> Dict[str, tuple]:
        """{name: (kind, target, creation order)} of the group's links."""
        if self._members is None:
            self._members = (self._symbol_table() if self._btree is not None
                             else self._links())
        return self._members

    def _symbol_table(self) -> Dict[str, tuple]:
        f, o, l_ = self._file, self._file._o, self._file._l
        btree, heap_at = self._btree, self._heap
        head = f._read(heap_at, 8 + 2 * l_ + o)
        if head[:4] != b"HEAP":
            raise ValueError(f"{f.path}: bad local heap at {heap_at:#x}")
        heap = f._read(f._uint(head, 8 + 2 * l_, o), f._uint(head, 8, l_))
        members = {}
        entry = 2 * o + 24
        for node in _btree_leaves(f, btree, 0, None):
            data = f._read(node, 8)
            if data[:4] != b"SNOD":
                raise ValueError(f"{f.path}: bad symbol table node at "
                                 f"{node:#x}")
            n = f._uint(data, 6, 2)
            table = f._read(node + 8, n * entry)
            for i in range(n):
                start = f._uint(table, i * entry, o)
                name = heap[start:heap.index(b"\0", start)].decode()
                members[name] = f._entry(table, i * entry, heap)
        return members

    def _links(self) -> Dict[str, tuple]:
        """A new-style group's links: its link messages (compact), or the
        link info message's fractal heap and name index (dense)."""
        f = self._file
        bodies = [b for k, _, b in self._msgs if k == _LINK]
        tracked = False
        for kind, _, body in self._msgs:
            if kind != _LINK_INFO:
                continue
            tracked = bool(body[1] & 1)
            pos = 2 + (8 if body[1] & 1 else 0)
            heap, names = f._uint(body, pos, f._o), f._uint(body,
                                                            pos + f._o, f._o)
            if f._defined(heap):
                bodies += list(index.dense_links(f, heap, names))
        links = [f._link(b) for b in bodies]
        if tracked:
            links.sort(key=lambda item: item[1][2])
        else:
            links.sort(key=lambda item: item[0].encode())
        return dict(links)

    def keys(self):
        return list(self._load())

    def __getitem__(self, path: str):
        return self._resolve(path, [0])

    def _resolve(self, path: str, hops: List[int]):
        """The object at `path`, from the root if it starts with "/";
        a soft link's value is resolved from the group that holds it."""
        f = self._file
        obj = f.root if path.startswith("/") else self
        for part in path.split("/"):
            if part in ("", "."):
                continue
            if not isinstance(obj, Group):
                raise KeyError(f"{path!r}: {part!r} is inside a dataset")
            members = obj._load()
            if part not in members:
                raise KeyError(f"object {path!r} doesn't exist")
            kind, target, _ = members[part]
            if kind == "hard":
                obj = f._object(target)
            elif kind == "soft":
                hops[0] += 1
                if hops[0] > MAX_SOFT_LINKS:  # h5py's error, a loop too
                    raise RuntimeError(f"{path!r}: too many soft links "
                                       f"(more than {MAX_SOFT_LINKS})")
                obj = obj._resolve(target, hops)
            else:
                raise f._unported(f"HDF5 {kind} links ({path!r})")
        return obj

    def __contains__(self, path: str) -> bool:
        """Whether the link `path` names exists, as h5py's `in`: the
        groups on the way must resolve, the last link need not (a
        dangling soft link is in its group)."""
        parent, _, last = path.rstrip("/").rpartition("/")
        if last in ("", "."):
            return True
        try:
            group = self[parent or ("/" if path.startswith("/") else ".")]
        except KeyError:
            return False
        return isinstance(group, Group) and last in group._load()

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
    """A dataset: `.shape`, `.maxshape`, `.dtype`, numpy-style reads of a
    box."""

    def __init__(self, file: File, address: int, msgs):
        self._file = file
        self.name = f"dataset at {address:#x}"
        self._key = address
        by_kind: Dict[int, bytes] = {}
        for kind, _, body in msgs:
            by_kind.setdefault(kind, body)
        if _EXTERNAL in by_kind:
            raise file._unported("HDF5 external data files")
        self.shape, self.maxshape = self._dataspace(by_kind[_DATASPACE])
        self.dtype, self._raw, self._bits = self._datatype(
            by_kind[_DATATYPE])
        self._fill = self._fill_value(by_kind.get(_FILL),
                                      by_kind.get(_FILL_OLD))
        self._filters = (self._pipeline(by_kind[_FILTERS])
                         if _FILTERS in by_kind else [])
        self._layout(by_kind[_LAYOUT])
        self._index = None

    # -- messages -------------------------------------------------------------
    def _dataspace(self, body: bytes):
        """(shape, maxshape: None on an unlimited axis)."""
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
        shape = tuple(f._uint(body, pos + i * f._l, f._l)
                      for i in range(rank))
        if not flags & 1:
            return shape, shape
        pos += rank * f._l
        unlimited = (1 << (8 * f._l)) - 1
        return shape, tuple(
            None if m == unlimited else m
            for m in (f._uint(body, pos + i * f._l, f._l)
                      for i in range(rank)))

    def _datatype(self, body: bytes):
        """(the values' dtype, the stored dtype, (offset, precision,
        signed) of an integer narrower than its bytes, else None)."""
        f = self._file
        cls, bits = body[0] & 15, int.from_bytes(body[1:4], "little")
        size = f._uint(body, 4, 4)
        if cls == 0:  # fixed-point
            offset, precision = struct.unpack_from("<HH", body, 8)
            if (size not in (1, 2, 4, 8) or precision < 1
                    or offset + precision > 8 * size):
                raise f._unported(f"HDF5 integers of {precision} bits at "
                                  f"offset {offset} in {size} bytes")
            order = ">" if bits & 1 else "<"
            dt = np.dtype(f"{order}{'i' if bits & 8 else 'u'}{size}")
            narrow = (None if (offset, precision) == (0, 8 * size)
                      else (offset, precision, bool(bits & 8)))
            return dt, np.dtype(f"{order}u{size}") if narrow else dt, narrow
        if cls == 1:  # floating-point
            layout = struct.unpack_from("<HHBBBBI", body, 8)
            if (bits & 0x40 or size not in _IEEE or layout[0] != 0
                    or layout[1:] != _IEEE[size]
                    or (bits >> 8) & 0xFF != 8 * size - 1):
                raise f._unported(f"HDF5 floats other than IEEE 754 of 2, 4 "
                                  f"or 8 bytes (size {size}, layout "
                                  f"{layout})")
            dt = np.dtype(f"{'>' if bits & 1 else '<'}f{size}")
            return dt, dt, None
        if cls == 3:  # fixed-length string
            dt = np.dtype(f"S{size}")
            return dt, dt, None
        if cls == 7:  # reference
            if bits & 15 != 0:
                raise f._unported("HDF5 region references")
            return np.dtype(object), np.dtype(f"<u{size}"), None
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
            if fid not in _FILTERS_READ:
                raise f._unported(f"the HDF5 filter "
                                  f"{_FILTER_NAMES.get(fid, fid)}")
            if fid == _SCALEOFFSET and data[3] == 1 and data[0] != 0:
                raise f._unported("the HDF5 filter scaleoffset of floats "
                                  "by E-scale")
            if fid == _NBIT and not data[1] and data[3] != 1:
                raise f._unported("the HDF5 filter nbit of compound or "
                                  "array datatypes")
            del flags  # an optional filter that ran is undone all the same
            out.append((fid, data))
        return out

    def _layout(self, body: bytes) -> None:
        f, o = self._file, self._file._o
        version, cls = body[0], body[1]
        if version not in (3, 4):
            raise f._unported(f"HDF5 data layout message version {version}")
        self._compact = self._address = self._chunk = None
        if cls == 0:
            size = f._uint(body, 2, 2)
            self._compact = body[4:4 + size]
        elif cls == 1:
            self._address = f._uint(body, 2, o)
        elif cls == 2 and version == 3:
            ndims = body[2]
            self._address = f._uint(body, 3, o)
            dims = struct.unpack_from(f"<{ndims}I", body, 3 + o)
            self._chunked(dims, _BTREE1, 0)
        elif cls == 2:
            flags, ndims, width = body[2], body[3], body[4]
            dims = [f._uint(body, 5 + i * width, width) for i in range(ndims)]
            pos = 5 + ndims * width
            kind = body[pos]
            pos += 1
            self._single = None
            if kind == _SINGLE and flags & 2:  # a filtered single chunk
                self._single = (f._uint(body, pos, f._l),
                                f._uint(body, pos + f._l, 4))
                pos += f._l + 4
            elif kind in (_FIXED_ARRAY, _EXTENSIBLE_ARRAY, _BTREE2):
                pos += {_FIXED_ARRAY: 1, _EXTENSIBLE_ARRAY: 5, _BTREE2: 6}[kind]
            elif kind not in (_SINGLE, _IMPLICIT):
                raise ValueError(f"{f.path}: chunk index type {kind}")
            self._address = f._uint(body, pos, o)
            self._chunked(dims, kind, flags & 1)
        else:
            raise f._unported("HDF5 virtual datasets")

    def _chunked(self, dims, kind: int, partial_unfiltered: int) -> None:
        f = self._file
        if dims[-1] != self._raw.itemsize or len(dims) - 1 != len(
                self.shape):
            raise ValueError(f"{f.path}: chunk dims {tuple(dims)} for "
                             f"{self.shape} {self._raw}")
        self._chunk = tuple(dims[:-1])
        self._kind = kind
        self._partial_unfiltered = bool(partial_unfiltered)
        self._chunk_nbytes = int(np.prod(self._chunk)) * self._raw.itemsize
        if kind in (_IMPLICIT, _FIXED_ARRAY, _EXTENSIBLE_ARRAY):
            # the chunk's linear index: row-major over the chunks of the
            # maximum dimensions, the unlimited axis first (swizzled) for
            # an extensible array
            axes = list(range(len(self.shape)))
            if kind == _EXTENSIBLE_ARRAY:
                unlimited = self.maxshape.index(None)
                axes = [unlimited] + [a for a in axes if a != unlimited]
            down, size = [0] * len(axes), 1
            for i in reversed(range(len(axes))):
                down[i] = size
                if i:
                    m = self.maxshape[axes[i]]
                    size *= -(-m // self._chunk[axes[i]])
            self._linear = list(zip(axes, down))

    # -- reads ----------------------------------------------------------------
    def __array__(self, dtype=None, copy=None):
        out = np.asarray(self[()])
        return out if dtype is None else out.astype(dtype)

    def __getitem__(self, key):
        box, post = _selection(key, self.shape)
        arr = self._read_box(box)
        if self._bits is not None:
            arr = self._narrow_to_native(arr)
        elif self._raw != self.dtype:  # references
            refs = np.empty(arr.shape, object)
            refs.ravel()[:] = [Reference(int(a)) for a in arr.ravel()]
            arr = refs
        return arr[post]

    def _narrow_to_native(self, arr: np.ndarray) -> np.ndarray:
        """An integer of `precision` bits at bit `offset` as HDF5 converts
        it to a full-width one: the field, sign-extended if signed."""
        offset, precision, signed = self._bits
        v = (arr.astype(np.uint64) >> np.uint64(offset)) & np.uint64(
            (1 << precision) - 1)
        if signed:
            v = v.astype(np.int64)
            v = np.where(v >= 1 << (precision - 1), v - (1 << precision), v)
        return v.astype(self.dtype)

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

    def _chunk_entry(self, coords: tuple):
        """(address, stored size, filter mask) of the chunk at the chunk
        grid's `coords`, None where it is not allocated."""
        f, kind = self._file, self._kind
        if not f._defined(self._address):
            return None
        if kind == _SINGLE:
            size, mask = self._single or (self._chunk_nbytes, 0)
            return self._address, size, mask
        if kind in (_IMPLICIT, _FIXED_ARRAY, _EXTENSIBLE_ARRAY):
            i = sum(coords[axis] * down for axis, down in self._linear)
            if kind == _IMPLICIT:
                return (self._address + i * self._chunk_nbytes,
                        self._chunk_nbytes, 0)
            if self._index is None:
                cls = (index.FixedArray if kind == _FIXED_ARRAY
                       else index.ExtensibleArray)
                self._index = cls(f, self._address, self._chunk_nbytes)
            return self._index.get(i)
        if self._index is None:
            if kind == _BTREE2:
                self._index = index.btree2_chunks(
                    f, self._address, len(self.shape), self._chunk_nbytes)
            else:
                nd = len(self.shape) + 1
                self._index = {}
                for key, child in _btree_leaves(f, self._address, 1,
                                                8 + 8 * nd):
                    size, mask = struct.unpack_from("<II", key, 0)
                    offset = struct.unpack_from(f"<{nd}Q", key, 8)[:-1]
                    self._index[tuple(a // c for a, c in zip(
                        offset, self._chunk))] = (child, size, mask)
        return self._index.get(coords)

    def _read_chunked(self, box, shape) -> np.ndarray:
        out = np.empty(shape, self._raw)
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
            entry = self._chunk_entry(coords)
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
        if self._partial_unfiltered and any(
                a + c > n for a, c, n in zip(offset, self._chunk,
                                             self.shape)):
            mask = -1  # an edge chunk stored unfiltered
        data = self._file._read(address, size)
        n = int(np.prod(self._chunk))
        for i in reversed(range(len(self._filters))):
            if mask & (1 << i):
                continue
            fid, client = self._filters[i]
            if fid == _DEFLATE:
                data = zlib.decompress(data)
            elif fid == _SHUFFLE:
                data = _unshuffle(data, client[0] if client else
                                  self._raw.itemsize)
            elif fid == _FLETCHER32:
                data = self._fletcher32_stripped(data, offset)
            elif fid == _LZF:
                from emsanet_tpu_torch import native

                data = native.lzf_decompress(
                    data, client[2] if len(client) > 2 and client[2]
                    else self._chunk_nbytes)
            elif fid == _NBIT:
                data = _nbit(data, client)
            else:
                data = self._scaleoffset(data, client, n)
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

    def _scaleoffset(self, data: bytes, client: tuple, n: int) -> bytes:
        """Undo the scaleoffset filter (`H5Zscaleoffset.c`): a 21-byte
        head (the packed width `minbits`, the minimum), then each value
        less the minimum in `minbits` bits, MSB first; the all-ones value
        marks the fill value where one is defined. Integers add the
        minimum back; floats (D-scale) divide by 10**D and add it, in
        their own precision. The values come out in the native
        (little-endian) order and go back to the dataset's."""
        size, is_float, fill_defined = client[4], client[3] == 1, client[7]
        native = np.dtype(f"<{'f' if is_float else 'iu'[not client[5]]}"
                          f"{size}")
        minbits = int.from_bytes(data[0:4], "little")
        if minbits == 8 * size:
            values = np.frombuffer(data, native, n, 21)
        else:
            packed = _unpack_bits(data[21:], n, minbits)
            if is_float:
                scale = struct.unpack("<i", struct.pack("<I", client[1]))[0]
                minimum = np.frombuffer(data, native, 1, 5)[0]
                values = (packed.astype(np.int64).astype(native)
                          / native.type(10.0 ** scale) + minimum)
            else:
                minimum = int.from_bytes(data[5:5 + data[4]], "little")
                values = packed + np.uint64(minimum & ((1 << 64) - 1))
                if size < 8:
                    values &= np.uint64((1 << (8 * size)) - 1)
                values = values.astype(f"<u{size}").view(native)
            if fill_defined:
                fill = np.frombuffer(self._fill, self._raw)[0]
                values = np.where(packed == np.uint64((1 << minbits) - 1),
                                  fill, values)
        return np.asarray(values, native).astype(self._raw).tobytes()


def _unpack_bits(data: bytes, n: int, bits: int) -> np.ndarray:
    """`n` unsigned values of `bits` bits each, packed MSB first (the
    packing of HDF5's nbit and scaleoffset filters), as uint64."""
    out = np.zeros(n, np.uint64)
    if bits == 0 or n == 0:
        return out
    stream = np.unpackbits(np.frombuffer(data, np.uint8), count=n * bits)
    if stream.size < n * bits:
        raise ValueError("packed HDF5 chunk data ends early")
    stream = stream.reshape(n, bits)
    for j in range(bits):
        out |= stream[:, j].astype(np.uint64) << np.uint64(bits - 1 - j)
    return out


def _nbit(data: bytes, client: tuple) -> bytes:
    """Undo the nbit filter of an integer or float (`H5Znbit.c`): each
    element's `precision` bits, MSB first, back at bit `offset` of an
    element of `size` bytes in the dataset's byte order; other bits 0.
    A client flag says the filter left the data as it was."""
    if client[1]:
        return data
    n, size, order, precision, offset = client[2], client[4], client[5], \
        client[6], client[7]
    values = _unpack_bits(data, n, precision) << np.uint64(offset)
    return values.astype(f"{'>' if order else '<'}u{size}").tobytes()


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
