"""The port's HDF5 reader (`emsanet_tpu_torch/datasets/hdf5.py`,
`hdf5_index.py`) on the newer file formats, against h5py, on the CPU.

An h5py-equality matrix: files written with libver 'earliest', 'v108',
'v110' and 'latest' (superblocks 0, 2, 3; version-1 and version-2
object headers), each with and without `track_order`; in each, datasets
of every layout and chunk index the libver gives (contiguous, compact;
chunked: single chunk, implicit, fixed array paged and not, extensible
array on the first and on another axis, v2 B-tree; v1 B-trees below
v110) under every filter h5py writes (none, gzip + shuffle + fletcher32,
lzf, nbit, scaleoffset) in two dtypes, nbit of narrow integers and
scaleoffset of floats; groups of every storage (symbol table, compact
links, dense links in a fractal heap), their keys in h5py's order, and
soft links (absolute, relative, chained, dangling). Every read equals
h5py's bit for bit, dtype and shape included. The checksums of the
superblock, object headers and every index block are verified (a
flipped byte raises), lookup3 equals Jenkins' published values, and
each structure left unported raises `NotPortedError` naming it.
"""

import numpy as np
import pytest

from emsanet_tpu_torch.config import NotPortedError
from emsanet_tpu_torch.datasets import hdf5
from emsanet_tpu_torch.datasets.hdf5_index import lookup3

h5py = pytest.importorskip("h5py")

LIBVERS = {"earliest": "earliest", "v108": ("v108", "latest"),
           "v110": ("v110", "latest"), "latest": "latest"}
SUPERBLOCK = {"earliest": 0, "v108": 2, "v110": 3, "latest": 3}
SHAPE, CHUNK = (7, 5, 3), (3, 2, 2)
LAYOUTS = {  # name: create_dataset keywords (chunked: its chunk index)
    "single": dict(chunks=SHAPE),
    "implicit": dict(chunks=CHUNK),  # with early allocation, below
    "fixed": dict(chunks=CHUNK),
    "fixed_maxshape": dict(chunks=CHUNK, maxshape=(10, 9, 3)),
    "extensible": dict(chunks=(1, 2, 2), maxshape=(None, 5, 3)),
    "extensible_axis1": dict(chunks=CHUNK, maxshape=(7, None, 3)),
    "btree2": dict(chunks=CHUNK, maxshape=(None, None, 3)),
}
FILTERS = ("none", "gzip_shuffle_fletcher32", "lzf", "nbit", "scaleoffset")
DTYPES = ("<i2", ">f8")
# the chunk index each libver gives a layout (layout message v4's types;
# 0: version 3's v1 B-tree)
INDEX = {"single": 1, "implicit": 2, "fixed": 3, "fixed_maxshape": 3,
         "extensible": 4, "extensible_axis1": 4, "btree2": 5}


def _values(dtype, shape, seed):
    rng = np.random.default_rng(seed)
    dt = np.dtype(dtype)
    if dt.kind == "f":
        return rng.normal(0, 100, shape).astype(dt)
    return rng.integers(-3000, 3000, shape).astype(dt)


def _dcpl(layout, filt):
    dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
    if filt == "nbit":
        dcpl.set_filter(h5py.h5z.FILTER_NBIT)
    if layout == "implicit":
        dcpl.set_alloc_time(h5py.h5d.ALLOC_TIME_EARLY)
    return dcpl


def _filter_kw(filt, dtype):
    if filt == "gzip_shuffle_fletcher32":
        return dict(compression="gzip", shuffle=True, fletcher32=True)
    if filt == "lzf":
        return dict(compression="lzf")
    if filt == "scaleoffset":
        return dict(scaleoffset=0 if dtype[1] == "i" else 3)
    return {}


def _compact(group, name, data):
    dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
    dcpl.set_layout(h5py.h5d.COMPACT)
    dsid = h5py.h5d.create(group.id, name.encode(),
                           h5py.h5t.py_create(data.dtype),
                           h5py.h5s.create_simple(data.shape), dcpl=dcpl)
    dsid.write(h5py.h5s.ALL, h5py.h5s.ALL, np.ascontiguousarray(data))


def _narrow(group, name, dtype, precision, offset, seed, filt):
    """An integer of `precision` bits at bit `offset`, chunked."""
    tid = h5py.h5t.py_create(np.dtype(dtype)).copy()
    tid.set_precision(precision)
    tid.set_offset(offset)
    dcpl = _dcpl("fixed", filt)
    dcpl.set_chunk((4, 3))
    signed = np.dtype(dtype).kind == "i"
    lo, hi = ((-(1 << (precision - 1)), (1 << (precision - 1)) - 1)
              if signed else (0, (1 << precision) - 1))
    data = np.random.default_rng(seed).integers(lo, hi, (9, 7),
                                                endpoint=True).astype(dtype)
    dsid = h5py.h5d.create(group.id, name.encode(), tid,
                           h5py.h5s.create_simple((9, 7)), dcpl=dcpl)
    dsid.write(h5py.h5s.ALL, h5py.h5s.ALL, data)


def write_matrix(path, libver, track_order):
    with h5py.File(path, "w", libver=LIBVERS[libver],
                   track_order=track_order) as f:
        seed = 0
        for dt in DTYPES:
            data = _values(dt, SHAPE, seed)
            f.create_dataset(f"contiguous/{dt}", data=data)
            _compact(f.require_group("compact"), dt, data)
            for layout, kw in LAYOUTS.items():
                for filt in FILTERS:
                    if layout == "implicit" and filt != "none":
                        continue  # an implicit index holds no filtered chunks
                    seed += 1
                    f.create_dataset(f"{layout}/{filt}/{dt}",
                                     data=_values(dt, SHAPE, seed),
                                     dcpl=_dcpl(layout, filt),
                                     **kw, **_filter_kw(filt, dt))
        # a fixed array of more chunks than a page holds (1024)
        f.create_dataset("fixed_paged", data=_values("<i2", (33, 40), 1),
                         chunks=(1, 1))
        # nbit of narrow integers, scaleoffset of floats with a fill value
        narrow = f.create_group("narrow")
        for i, (dt, precision, offset) in enumerate(
                (("<u2", 12, 0), ("<i2", 12, 2), (">i4", 20, 5),
                 ("<u1", 3, 4), ("<i8", 40, 3))):
            _narrow(narrow, f"nbit{dt}", dt, precision, offset, i, "nbit")
            _narrow(narrow, f"plain{dt}", dt, precision, offset, i, "none")
        for i, dt in enumerate(("<f4", ">f4", "<f8")):
            f.create_dataset(f"floats/{dt}", data=_values(dt, (20, 30), i),
                             chunks=(7, 8), scaleoffset=2, fillvalue=3.5)
        # groups: compact (3 links), dense (20 links), soft links
        small = f.create_group("small", track_order=track_order)
        for name in ("b", "c", "a"):
            small[name] = np.arange(len(name) + 3, dtype="<u1")
        dense = f.create_group("dense", track_order=track_order)
        for i in (5, 17, 0, 12, 3, 19, 8, 1, 14, 10, 2, 18, 6, 16, 4, 13, 7,
                  11, 15, 9):
            dense[f"m{i:02d}"] = np.full(i + 1, i, "<i4")
        f["dense/absolute"] = h5py.SoftLink("/small/a")
        f["dense/relative"] = h5py.SoftLink("m03")
        f["chain"] = h5py.SoftLink("/dense/absolute")
        f["to_group"] = h5py.SoftLink("dense")
        f["dangling"] = h5py.SoftLink("/nothing/here")


@pytest.fixture(scope="module", params=[(v, t) for v in LIBVERS
                                        for t in (False, True)],
                ids=lambda p: f"{p[0]}-{'tracked' if p[1] else 'untracked'}")
def matrix(request, tmp_path_factory):
    libver, track_order = request.param
    path = str(tmp_path_factory.mktemp("latest") / "matrix.h5")
    write_matrix(path, libver, track_order)
    return path, libver, track_order


def _same(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.tobytes() == want.tobytes()


def _reads(ds, ref):
    assert ds.shape == ref.shape and ds.dtype == ref.dtype
    _same(np.asarray(ds), ref[()])
    for i in range(ref.shape[0]):
        _same(ds[i], ref[i])
    if ref.ndim < 2:
        _same(ds[1:], ref[1:])
        return
    _same(ds[1:, 1], ref[1:, 1])
    _same(ds[..., -1], ref[..., -1])
    _same(ds[::2, 1:], ref[::2, 1:])


def _datasets(ref):
    names = []
    ref.visititems(lambda n, obj: names.append(n)
                   if isinstance(obj, h5py.Dataset) else None)
    return sorted(names)


def test_every_layout_and_filter_equals_h5py(matrix):
    path, libver, _ = matrix
    with hdf5.File(path) as f, h5py.File(path, "r") as ref:
        assert f._read(0, 9)[8] == SUPERBLOCK[libver]
        names = _datasets(ref)
        assert len(names) > 70
        for name in names:
            _reads(f[name], ref[name])
        assert f["btree2/none/<i2"].maxshape == ref["btree2/none/<i2"].maxshape
        # the chunk indexes the libver gives: v1 B-trees below 1.10
        for layout, kind in INDEX.items():
            got = f[f"{layout}/none/<i2"]._kind
            assert got == (kind if libver in ("v110", "latest") else 0)


def test_every_group_storage_and_link_equals_h5py(matrix):
    path, libver, track_order = matrix
    with hdf5.File(path) as f, h5py.File(path, "r") as ref:
        for group in ("/", "small", "dense", "narrow", "to_group"):
            assert f[group].keys() == list(ref[group].keys())
        storage = {k for k, _, _ in f["dense"]._msgs}
        if libver == "earliest" and not track_order:
            assert f["dense"]._btree is not None  # a symbol table
        else:
            assert f["dense"]._btree is None and 0x2 in storage
            assert 0x6 not in storage  # 20 links: dense, in a heap
            assert 0x6 in {k for k, _, _ in f["small"]._msgs}  # compact
        for name in ("dense/absolute", "dense/relative", "chain",
                     "to_group/m07", "/dense/m19", "small/b"):
            _same(f[name][()], ref[name][()])
        for name in ("dangling", "chain", "dense/relative", "nothing",
                     "dense/nothing", "small/a/x"):
            assert (name in f) == (name in ref), name
        assert f.get("dangling") is None and ref.get("dangling") is None
        with pytest.raises(KeyError):
            f["dangling"]


def test_soft_link_loops_raise_as_h5py(tmp_path):
    path = str(tmp_path / "loop.h5")
    with h5py.File(path, "w", libver="latest") as f:
        f["a"] = h5py.SoftLink("/b")
        f["b"] = h5py.SoftLink("/a")
    with hdf5.File(path) as f, h5py.File(path, "r") as ref:
        for got in (f, ref):
            assert "a" in got
            with pytest.raises(RuntimeError, match="too many"):
                got["a"]


def test_lookup3_equals_jenkins_published_values():
    assert lookup3(b"") == 0xDEADBEEF
    assert lookup3(b"Four score and seven years ago") == 0x17770551
    assert lookup3(b"Four score and seven years ago", 1) == 0xCD628161


FLIPS = {  # signature: a byte the block's checksum covers
    b"\x89HDF": 20, b"OHDR": None, b"BTHD": 16, b"BTLF": 6, b"FAHD": 8,
    b"FADB": 6, b"EAHD": 12, b"EAIB": 6, b"FRHP": 20}


@pytest.mark.parametrize("signature", list(FLIPS), ids=lambda s: s.decode(
    "latin1").strip("\x89"))
def test_a_flipped_byte_fails_its_checksum(tmp_path, signature):
    path = str(tmp_path / "m.h5")
    write_matrix(path, "latest", False)
    with h5py.File(path, "r") as ref:
        names = []
        ref.visititems(lambda n, obj: names.append(n))
    blob = bytearray(open(path, "rb").read())
    starts, at = [], blob.find(signature)
    while at >= 0:
        starts.append(at)
        at = blob.find(signature, at + 1)
    assert starts
    # the first, a middle and the last block of the kind
    for start in sorted({starts[0], starts[len(starts) // 2], starts[-1]}):
        flipped = bytearray(blob)
        offset = FLIPS[signature]
        if offset is None:  # into the first message of the first chunk
            flags = blob[start + 5]
            offset = (6 + (16 if flags & 0x20 else 0)
                      + (4 if flags & 0x10 else 0) + (1 << (flags & 3)) + 1)
        flipped[start + offset] ^= 0x40
        bad = str(tmp_path / "flipped.h5")
        open(bad, "wb").write(bytes(flipped))
        with pytest.raises(ValueError, match="checksum"):
            with hdf5.File(bad) as f:  # every object, every element
                for name in names:
                    obj = f[name]
                    if isinstance(obj, hdf5.Group):
                        obj.keys()
                    else:
                        np.asarray(obj)


def _unported(tmp_path, case):
    path = str(tmp_path / f"{case}.h5")
    fapl = h5py.h5p.create(h5py.h5p.FILE_ACCESS)
    fapl.set_libver_bounds(h5py.h5f.LIBVER_LATEST, h5py.h5f.LIBVER_LATEST)
    fid = h5py.h5f.create(path.encode(), h5py.h5f.ACC_TRUNC, fapl=fapl)
    with h5py.File(fid) as f:
        if case == "szip":
            f.create_dataset("x", data=np.arange(64.0), chunks=(32,),
                             compression="szip")
        elif case == "external_file":
            f.create_dataset("x", (4,), "<i4", external=[(
                str(tmp_path / "raw.bin"), 0, 16)])
        elif case == "external_link":
            f["x"] = h5py.ExternalLink("other.h5", "/y")
        elif case == "shared_messages":  # a committed datatype's users
            f["t"] = np.dtype("<f8")
            f.create_dataset("x", data=np.arange(6.0), dtype=f["t"])
        elif case == "virtual":
            f["src"] = np.arange(6)
            layout = h5py.VirtualLayout((6,), "<i8")
            layout[:] = h5py.VirtualSource(f["src"])
            f.create_virtual_dataset("x", layout)
    return path


@pytest.mark.parametrize("case,want", [
    ("szip", "the HDF5 filter szip"),
    ("external_file", "HDF5 external data files"),
    ("external_link", "HDF5 external links"),
    ("shared_messages", "shared HDF5 messages"),
    ("virtual", "HDF5 virtual datasets")])
def test_unported_structures_raise_naming_them(tmp_path, case, want):
    path = _unported(tmp_path, case)
    with hdf5.File(path) as f:
        with pytest.raises(NotPortedError, match=want):
            f["x"][()]


def test_lzf_rejects_a_corrupt_stream():
    """The host library's LZF decoder: a literal run and a back
    reference decode; a reference before the output's start, a run past
    the input's end or past the output's size raise."""
    from emsanet_tpu_torch import native

    good = bytes([2]) + b"abc" + bytes([0x20, 2])  # "abc", then 3 from -3
    assert native.lzf_decompress(good, 6) == b"abcabc"
    for bad, size in ((bytes([0x20, 0]), 8), (bytes([5]) + b"ab", 8),
                      (good, 5)):
        with pytest.raises(ValueError, match="corrupt LZF"):
            native.lzf_decompress(bad, size)
