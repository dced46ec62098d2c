"""The index structures of HDF5's newer file format, for `hdf5.py`:

  - `lookup3`: Jenkins' lookup3 hash, the checksum of every block below
    and of superblocks 2 / 3 and version-2 object headers;
  - `BTree2`: the version-2 B-tree (`BTHD`, `BTIN`, `BTLF`), its records
    in key order (a dense group's name index, type 5; a chunk index,
    types 10 and 11);
  - `FractalHeap`: the fractal heap (`FRHP`, `FHIB`, `FHDB`) of a dense
    group's link messages: managed and tiny objects;
  - `FixedArray` (`FAHD`, `FADB`, paged or not) and `ExtensibleArray`
    (`EAHD`, `EAIB`, `EASB`, `EADB`): chunk indexes of layout message
    version 4, each element read on demand.

Every block's checksum is verified; a mismatch raises ValueError. The
structures take the `hdf5.File` they live in (its `_read`, `_uint`,
sizes of offsets and lengths, `_unported`).
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Tuple

_M = 0xFFFFFFFF


def _rot(x: int, k: int) -> int:
    return ((x << k) | (x >> (32 - k))) & _M


def lookup3(data: bytes, initval: int = 0) -> int:
    """Jenkins' lookup3 `hashlittle` (HDF5's `H5_checksum_lookup3`)."""
    n = len(data)
    a = b = c = (0xDEADBEEF + n + initval) & _M
    pos = 0
    while n - pos > 12:
        a = (a + int.from_bytes(data[pos:pos + 4], "little")) & _M
        b = (b + int.from_bytes(data[pos + 4:pos + 8], "little")) & _M
        c = (c + int.from_bytes(data[pos + 8:pos + 12], "little")) & _M
        a = (a - c) & _M; a ^= _rot(c, 4); c = (c + b) & _M    # noqa: E702
        b = (b - a) & _M; b ^= _rot(a, 6); a = (a + c) & _M    # noqa: E702
        c = (c - b) & _M; c ^= _rot(b, 8); b = (b + a) & _M    # noqa: E702
        a = (a - c) & _M; a ^= _rot(c, 16); c = (c + b) & _M   # noqa: E702
        b = (b - a) & _M; b ^= _rot(a, 19); a = (a + c) & _M   # noqa: E702
        c = (c - b) & _M; c ^= _rot(b, 4); b = (b + a) & _M    # noqa: E702
        pos += 12
    if pos == n:
        return c
    tail = data[pos:] + bytes(12 - (n - pos))  # the byte-wise tail cases
    a = (a + int.from_bytes(tail[0:4], "little")) & _M
    b = (b + int.from_bytes(tail[4:8], "little")) & _M
    c = (c + int.from_bytes(tail[8:12], "little")) & _M
    c ^= b; c = (c - _rot(b, 14)) & _M   # noqa: E702
    a ^= c; a = (a - _rot(c, 11)) & _M   # noqa: E702
    b ^= a; b = (b - _rot(a, 25)) & _M   # noqa: E702
    c ^= b; c = (c - _rot(b, 16)) & _M   # noqa: E702
    a ^= c; a = (a - _rot(c, 4)) & _M    # noqa: E702
    b ^= a; b = (b - _rot(a, 14)) & _M   # noqa: E702
    c ^= b; c = (c - _rot(b, 24)) & _M   # noqa: E702
    return c


def checked(f, address: int, data: bytes, what: str) -> bytes:
    """`data` less its last 4 bytes, which must be their lookup3."""
    if lookup3(data[:-4]) != int.from_bytes(data[-4:], "little"):
        raise ValueError(f"{f.path}: the checksum of the {what} at "
                         f"{address:#x} does not match")
    return data[:-4]


def _signed(f, address: int, n: int, signature: bytes, what: str) -> bytes:
    """The block of `n` bytes at `address`, signature and checksum
    checked (version 0 where the block has one)."""
    data = f._read(address, n)
    if data[:4] != signature:
        raise ValueError(f"{f.path}: bad {what} at {address:#x}")
    return checked(f, address, data, what)


def enc_size(value: int) -> int:
    """HDF5's `H5VM_limit_enc_size`: bytes to encode values up to
    `value`."""
    return (max(value, 1).bit_length() - 1) // 8 + 1


def log2(value: int) -> int:
    return max(value, 1).bit_length() - 1


class BTree2:
    """A version-2 B-tree; `records()` yields each record's bytes in key
    order."""

    def __init__(self, f, address: int):
        o, l_ = f._o, f._l
        head = _signed(f, address, 4 + 1 + 1 + 4 + 2 + 2 + 2 + o + 2 + l_
                       + 4, b"BTHD", "v2 B-tree header")
        self._f = f
        self.type = head[5]
        node_size, self.record_size, self.depth = (
            f._uint(head, 6, 4), f._uint(head, 10, 2), f._uint(head, 12, 2))
        self._root, self._root_n = f._uint(head, 16, o), f._uint(head,
                                                                 16 + o, 2)
        # H5B2__hdr_init: records per node, and the widths of a child
        # pointer's record counts, level by level
        max_n = [(node_size - 10) // self.record_size]
        cum_max, cum_size = [max_n[0]], [0]
        self._n_size = enc_size(max_n[0])
        for d in range(1, self.depth + 1):
            ptr = o + self._n_size + (cum_size[d - 1] if d > 1 else 0)
            max_n.append((node_size - 10 - ptr) // (self.record_size + ptr))
            cum_max.append((max_n[d] + 1) * cum_max[d - 1] + max_n[d])
            cum_size.append(enc_size(cum_max[d]))
        self._cum_size = cum_size

    def records(self) -> Iterator[bytes]:
        if self._f._defined(self._root) and self._root_n:
            yield from self._node(self._root, self._root_n, self.depth)

    def _node(self, address: int, n: int, depth: int) -> Iterator[bytes]:
        f, rs = self._f, self.record_size
        if depth == 0:
            data = _signed(f, address, 6 + n * rs + 4, b"BTLF",
                           "v2 B-tree leaf")
            for i in range(n):
                yield data[6 + i * rs:6 + (i + 1) * rs]
            return
        total = self._cum_size[depth - 1] if depth > 1 else 0
        ptr = f._o + self._n_size + total
        data = _signed(f, address, 6 + n * rs + (n + 1) * ptr + 4, b"BTIN",
                       "v2 B-tree internal node")
        pos = 6 + n * rs
        for i in range(n + 1):
            child = f._uint(data, pos, f._o)
            child_n = f._uint(data, pos + f._o, self._n_size)
            pos += ptr
            yield from self._node(child, child_n, depth - 1)
            if i < n:
                yield data[6 + i * rs:6 + (i + 1) * rs]


class FractalHeap:
    """A fractal heap; `object(heap_id)` returns an object's bytes."""

    def __init__(self, f, address: int):
        o, l_ = f._o, f._l
        size = 14 + 12 * l_ - 2 * l_ + 2 * o + 2 + l_ + l_ + 2 + 2 + o + 2
        head = f._read(address, size + 4)
        if head[:4] != b"FRHP":
            raise ValueError(f"{f.path}: bad fractal heap at {address:#x}")
        self._f = f
        self.id_length, filter_length = f._uint(head, 5, 2), f._uint(head,
                                                                     7, 2)
        if filter_length:
            raise f._unported("filtered HDF5 fractal heaps")
        checked(f, address, head, "fractal heap header")
        flags, self._max_managed = head[9], f._uint(head, 10, 4)
        self._checksummed = bool(flags & 2)
        pos = 14 + 10 * l_ + 2 * o  # past the space and object counts
        self._width = f._uint(head, pos, 2)
        self._start = f._uint(head, pos + 2, l_)
        self._max_direct = f._uint(head, pos + 2 + l_, l_)
        max_heap_bits = f._uint(head, pos + 2 + 2 * l_, 2)
        self._root = f._uint(head, pos + 6 + 2 * l_, o)
        self._root_rows = f._uint(head, pos + 6 + 2 * l_ + o, 2)
        self._off_size = (max_heap_bits + 7) // 8
        self._len_size = min((log2(self._max_direct) + 7) // 8,
                             enc_size(self._max_managed))
        self._max_direct_rows = (log2(self._max_direct) - log2(self._start)
                                 + 2)
        self._blocks: Dict[int, bytes] = {}

    def _row_size(self, row: int) -> int:
        return self._start if row == 0 else self._start << (row - 1)

    def object(self, heap_id: bytes) -> bytes:
        f = self._f
        kind = (heap_id[0] >> 4) & 3
        if heap_id[0] >> 6:
            raise ValueError(f"{f.path}: fractal heap ID version "
                             f"{heap_id[0] >> 6}")
        if kind == 2:  # tiny: the object is in the ID
            if self.id_length <= 18:
                n = (heap_id[0] & 15) + 1
                return heap_id[1:1 + n]
            n = (((heap_id[0] & 15) << 8) | heap_id[1]) + 1
            return heap_id[2:2 + n]
        if kind != 0:
            raise f._unported("huge objects of HDF5 fractal heaps")
        offset = f._uint(heap_id, 1, self._off_size)
        length = f._uint(heap_id, 1 + self._off_size, self._len_size)
        start, block = self._direct_block(offset)
        obj = block[offset - start:offset - start + length]
        if len(obj) != length:
            raise ValueError(f"{f.path}: a fractal heap object past its "
                             "block")
        return obj

    def _direct_block(self, offset: int) -> Tuple[int, bytes]:
        """(the heap offset of the direct block holding `offset`, its
        bytes)."""
        f = self._f
        if self._root_rows == 0:
            return 0, self._read_direct(self._root, self._start)
        address, base, rows = self._root, 0, self._root_rows
        while True:
            n_direct = min(rows, self._max_direct_rows)
            entries = n_direct * self._width + max(
                rows - self._max_direct_rows, 0) * self._width
            head = 5 + f._o + self._off_size
            data = self._block(address, head + entries * f._o + 4, b"FHIB",
                               "fractal heap indirect block", True)
            rel, row_start = offset - base, 0
            for row in range(rows):
                span = self._width * self._row_size(row)
                if rel < row_start + span:
                    break
                row_start += span
            else:
                raise ValueError(f"{f.path}: heap offset {offset} past its "
                                 "fractal heap")
            size = self._row_size(row)
            col = (rel - row_start) // size
            child_base = base + row_start + col * size
            child = f._uint(data, head + (row * self._width + col) * f._o,
                            f._o)
            if not f._defined(child):
                raise ValueError(f"{f.path}: heap offset {offset} in an "
                                 "unallocated fractal heap block")
            if row < self._max_direct_rows:
                return child_base, self._read_direct(child, size)
            address, base = child, child_base
            rows = log2(size) - log2(self._start) - log2(self._width) + 1

    def _read_direct(self, address: int, size: int) -> bytes:
        return self._block(address, size, b"FHDB", "fractal heap direct "
                           "block", False)

    def _block(self, address: int, size: int, signature: bytes, what: str,
               trailing_checksum: bool) -> bytes:
        if address in self._blocks:
            return self._blocks[address]
        f = self._f
        data = f._read(address, size)
        if data[:4] != signature:
            raise ValueError(f"{f.path}: bad {what} at {address:#x}")
        if trailing_checksum:
            checked(f, address, data, what)
        elif self._checksummed:  # the field itself zeroed for the sum
            at = 5 + f._o + self._off_size
            want = int.from_bytes(data[at:at + 4], "little")
            if lookup3(data[:at] + bytes(4) + data[at + 4:]) != want:
                raise ValueError(f"{f.path}: the checksum of the {what} at "
                                 f"{address:#x} does not match")
        self._blocks[address] = data
        return data


# -- chunk indexes --------------------------------------------------------

def chunk_entry(f, raw: bytes, filtered: bool, chunk_bytes: int):
    """A chunk index element: its address, and where the chunks are
    filtered the stored size and the filter mask; None if unallocated."""
    o = f._o
    address = f._uint(raw, 0, o)
    if not f._defined(address):
        return None
    if not filtered:
        return address, chunk_bytes, 0
    size_len = len(raw) - o - 4
    return (address, f._uint(raw, o, size_len),
            f._uint(raw, o + size_len, 4))


class FixedArray:
    """A fixed array chunk index: `get(i)` -> `chunk_entry` of chunk i."""

    def __init__(self, f, address: int, chunk_bytes: int):
        o, l_ = f._o, f._l
        head = _signed(f, address, 8 + l_ + o + 4, b"FAHD",
                       "fixed array header")
        self._f, self._chunk_bytes = f, chunk_bytes
        self._filtered = bool(head[5])
        self._esize, page_bits = head[6], head[7]
        self._n = f._uint(head, 8, l_)
        self._dblock = f._uint(head, 8 + l_, o)
        self._page_n = 1 << page_bits
        self._pages = (-(-self._n // self._page_n)
                       if self._n > self._page_n else 0)
        self._cache: Dict[int, bytes] = {}

    def get(self, i: int):
        f = self._f
        if not f._defined(self._dblock) or not 0 <= i < self._n:
            return None
        bitmap = (self._pages + 7) // 8
        prefix = 6 + f._o + bitmap + 4
        if not self._pages:
            block = self._cached(-1, lambda: _signed(
                f, self._dblock, prefix + self._n * self._esize, b"FADB",
                "fixed array data block")[prefix - 4:])
            raw = block[i * self._esize:(i + 1) * self._esize]
            return chunk_entry(f, raw, self._filtered, self._chunk_bytes)
        head = self._cached(-1, lambda: _signed(
            f, self._dblock, prefix, b"FADB", "fixed array data block"))
        page = i // self._page_n
        if not head[6 + f._o + page // 8] & (0x80 >> (page % 8)):
            return None  # an uninitialised page: no chunk allocated
        n = min(self._page_n, self._n - page * self._page_n)
        at = self._dblock + prefix + page * (self._page_n * self._esize + 4)
        data = self._cached(page, lambda: checked(
            f, at, f._read(at, n * self._esize + 4),
            "fixed array data block page"))
        j = i - page * self._page_n
        return chunk_entry(f, data[j * self._esize:(j + 1) * self._esize],
                           self._filtered, self._chunk_bytes)

    def _cached(self, key: int, read) -> bytes:
        if key not in self._cache:
            self._cache[key] = read()
        return self._cache[key]


class ExtensibleArray:
    """An extensible array chunk index: `get(i)` -> `chunk_entry`."""

    def __init__(self, f, address: int, chunk_bytes: int):
        o, l_ = f._o, f._l
        head = _signed(f, address, 12 + 6 * l_ + o + 4, b"EAHD",
                       "extensible array header")
        self._f, self._chunk_bytes = f, chunk_bytes
        self._filtered = bool(head[5])
        self._esize, max_bits, self._iblock_n = head[6], head[7], head[8]
        self._min_n, min_ptrs, page_bits = head[9], head[10], head[11]
        self._page_n = 1 << page_bits
        self._iblock = f._uint(head, 12 + 6 * l_, o)
        self._off_size = (max_bits + 7) // 8
        n_sblocks = 1 + max_bits - log2(self._min_n)
        # H5EA__hdr_init: each super block's data blocks, their elements
        # and the first element and data block of each
        self._sblocks: List[Tuple[int, int, int, int]] = []
        start = dblk = 0
        for s in range(n_sblocks):
            n_dblk, n_elem = 1 << (s // 2), (1 << ((s + 1) // 2)) * self._min_n
            self._sblocks.append((n_dblk, n_elem, start, dblk))
            start += n_dblk * n_elem
            dblk += n_dblk
        self._iblock_sblocks = 2 * log2(min_ptrs)
        self._n_dblk_addrs = 2 * (min_ptrs - 1)
        self._n_sblk_addrs = n_sblocks - self._iblock_sblocks
        self._cache: Dict[int, bytes] = {}

    def _block(self, address: int, size: int, signature: bytes,
               what: str) -> bytes:
        if address not in self._cache:
            self._cache[address] = _signed(self._f, address, size, signature,
                                           what)
        return self._cache[address]

    def get(self, i: int):
        f, o, es = self._f, self._f._o, self._esize
        if not f._defined(self._iblock):
            return None
        head = 6 + o
        iblock = self._block(self._iblock, head + self._iblock_n * es
                             + (self._n_dblk_addrs + self._n_sblk_addrs) * o
                             + 4, b"EAIB", "extensible array index block")
        if i < self._iblock_n:
            return chunk_entry(f, iblock[head + i * es:head + (i + 1) * es],
                               self._filtered, self._chunk_bytes)
        e = i - self._iblock_n
        s = log2(e // self._min_n + 1)
        n_dblk, n_elem, start, first_dblk = self._sblocks[s]
        if n_elem > self._page_n:
            raise f._unported("paged data blocks of HDF5 extensible arrays")
        k, j = divmod(e - start, n_elem)
        addrs = head + self._iblock_n * es
        if s < self._iblock_sblocks:
            dblock = f._uint(iblock, addrs + (first_dblk + k) * o, o)
        else:
            sblock = f._uint(iblock, addrs + (self._n_dblk_addrs + s
                                              - self._iblock_sblocks) * o, o)
            if not f._defined(sblock):
                return None
            sb_head = head + self._off_size
            data = self._block(sblock, sb_head + n_dblk * o + 4, b"EASB",
                               "extensible array super block")
            dblock = f._uint(data, sb_head + k * o, o)
        if not f._defined(dblock):
            return None
        db_head = head + self._off_size
        data = self._block(dblock, db_head + n_elem * es + 4, b"EADB",
                           "extensible array data block")
        return chunk_entry(f, data[db_head + j * es:db_head + (j + 1) * es],
                           self._filtered, self._chunk_bytes)


def btree2_chunks(f, address: int, rank: int, chunk_bytes: int
                  ) -> Dict[tuple, tuple]:
    """{scaled chunk offset: (address, size, mask)} of a v2 B-tree chunk
    index (record type 10: unfiltered, 11: filtered)."""
    tree = BTree2(f, address)
    if tree.type not in (10, 11):
        raise ValueError(f"{f.path}: a v2 B-tree of type {tree.type} as a "
                         "chunk index")
    o, out = f._o, {}
    for rec in tree.records():
        if tree.type == 10:
            entry, pos = (f._uint(rec, 0, o), chunk_bytes, 0), o
        else:
            size_len = tree.record_size - o - 4 - 8 * rank
            entry = (f._uint(rec, 0, o), f._uint(rec, o, size_len),
                     f._uint(rec, o + size_len, 4))
            pos = o + size_len + 4
        scaled = tuple(f._uint(rec, pos + 8 * i, 8) for i in range(rank))
        out[scaled] = entry
    return out


def dense_links(f, heap_address: int, name_index: int) -> Iterator[bytes]:
    """The link messages of a dense group: its name index (a v2 B-tree of
    type 5: name hash, heap ID) into its fractal heap."""
    heap = FractalHeap(f, heap_address)
    tree = BTree2(f, name_index)
    if tree.type != 5:
        raise ValueError(f"{f.path}: a v2 B-tree of type {tree.type} as a "
                         "group's name index")
    for rec in tree.records():
        yield heap.object(rec[4:4 + heap.id_length])

