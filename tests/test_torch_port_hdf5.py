"""The port's HDF5 reader (`emsanet_tpu_torch/datasets/hdf5.py`) against
h5py, on the CPU: every read (`ds[i]` for every i, slices, `ds[...]`,
`ds[:]`, `np.asarray(ds)`) equal to h5py's bit for bit, dtype and shape
included, over a parametrised matrix of files that h5py writes with its
default `libver='earliest'`: compact, contiguous and chunked layouts;
edge chunks and unallocated chunks and storage read as the fill value;
no filter, gzip, shuffle + gzip and fletcher32; every supported dtype in
both byte orders; user blocks of 0 and 512 bytes; group B-trees several
levels deep, nested groups and chunk B-trees several levels deep,
4-byte addresses; object references into a `#refs#` group, as
MATLAB writes them. Files of the newer formats read equal too (the
matrix over libver, layouts and chunk indexes, filters and group storage:
`tests/test_torch_port_hdf5_latest.py`); structures the reader does not
cover raise `NotPortedError` naming the structure.
"""

import numpy as np
import pytest

from emsanet_tpu_torch.config import NotPortedError
from emsanet_tpu_torch.datasets import hdf5

h5py = pytest.importorskip("h5py")

DTYPES = [f"{order}{kind}" for order in "<>"
          for kind in ("i1", "u1", "i2", "u2", "i4", "u4", "i8", "u8", "f2",
                       "f4", "f8")]
# name: h5py create_dataset keywords of a chunked dataset
FILTERS = {"none": {}, "gzip": dict(compression="gzip"),
           "shuffle_gzip": dict(compression="gzip", shuffle=True),
           "fletcher32": dict(fletcher32=True),
           "all": dict(compression="gzip", compression_opts=9, shuffle=True,
                       fletcher32=True)}


def _values(dtype, shape, seed):
    rng = np.random.default_rng(seed)
    dt = np.dtype(dtype)
    if dt.kind == "f":
        arr = rng.normal(0, 100, shape)
        arr.ravel()[::7] = np.nan
        arr.ravel()[3::11] = -np.inf
    else:
        info = np.iinfo(dt)
        arr = rng.integers(info.min, info.max, shape, endpoint=True,
                           dtype=dt.newbyteorder("="))
    return arr.astype(dt)


def _compact(f, name, data):
    """A dataset with the compact layout (the data in its header)."""
    dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
    dcpl.set_layout(h5py.h5d.COMPACT)
    space = h5py.h5s.create_simple(data.shape)
    tid = h5py.h5t.py_create(data.dtype)
    group, leaf = name.rsplit("/", 1)
    dsid = h5py.h5d.create(f.require_group(group).id, leaf.encode(), tid,
                           space, dcpl=dcpl)
    dsid.write(h5py.h5s.ALL, h5py.h5s.ALL, np.ascontiguousarray(data))


def _write(path, userblock):
    """The matrix's file; returns the names of its datasets."""
    with h5py.File(path, "w", userblock_size=userblock) as f:
        for i, dt in enumerate(DTYPES):
            data = _values(dt, (7, 5, 3), i)
            f.create_dataset(f"contiguous/{dt}", data=data)
            _compact(f, f"compact/{dt}", data)
            for fname, kw in FILTERS.items():
                if fname != "none" and dt[1:] not in ("u1", "i4", "f2",
                                                      "f8"):
                    continue
                # (7, 5, 3) in (3, 2, 2) chunks: edge chunks on every axis
                f.create_dataset(f"chunked/{fname}/{dt}", data=data,
                                 chunks=(3, 2, 2), **kw)
        # fill values: unallocated chunks, unallocated contiguous storage
        part = f.create_dataset("fill/chunks", (9, 8), "<i2", chunks=(4, 3),
                                fillvalue=-7, compression="gzip")
        part[1:3, 2:5] = 11
        f.create_dataset("fill/untouched_chunks", (5, 4), ">f4",
                         chunks=(2, 2), fillvalue=1.5)
        f.create_dataset("fill/contiguous", (6, 3), "<u2", fillvalue=9)
        f.create_dataset("fill/default", (4, 4), "<f8", chunks=(3, 3))
        # scalars and strings
        f["scalar/int"] = np.int32(-5)
        f["scalar/float"] = np.float64(2.5)
        f["strings"] = np.array([b"wall", b"floor", b"", b"bookshelf"],
                                "S9")
        # one chunk per frame, as the NYUv2 file stores its frames
        f.create_dataset("frames", data=_values("u1", (4, 3, 10, 8), 99),
                         chunks=(1, 3, 10, 8), compression="gzip")
        # MATLAB's cells: references into #refs#
        refs = f.create_dataset("cells", (1, 3), dtype=h5py.ref_dtype)
        for i, word in enumerate(("kitchen", "bedroom", "office")):
            ds = f.create_dataset(f"#refs#/{chr(97 + i)}", data=np.array(
                [[ord(c)] for c in word], np.uint16))
            ds.attrs["MATLAB_class"] = np.bytes_("char")
            refs[0, i] = ds.ref
        names = []
        f.visititems(lambda n, obj: names.append(n)
                     if isinstance(obj, h5py.Dataset) else None)
    return sorted(names)


@pytest.fixture(scope="module", params=[0, 512], ids=["no_userblock",
                                                     "userblock512"])
def matrix(request, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("hdf5") / "matrix.h5")
    return path, _write(path, request.param)


def _same(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.tobytes() == want.tobytes()


def _all_reads(ds, ref):
    assert ds.shape == ref.shape and ds.dtype == ref.dtype
    _same(np.asarray(ds), ref[()])
    if not ref.shape:
        _same(ds[()], ref[()])
        return
    _same(ds[...], ref[...])
    _same(ds[:], ref[:])
    for i in range(ref.shape[0]):
        _same(ds[i], ref[i])
        _same(ds[i - ref.shape[0]], ref[i - ref.shape[0]])
    n = ref.shape[0]
    for a, b in ((0, 1), (1, n), (n // 2, n), (n, n)):
        _same(ds[a:b], ref[a:b])
    if ref.ndim > 1:
        _same(ds[1:, 1], ref[1:, 1])
        _same(ds[..., 0], ref[..., 0])
        _same(ds[::2, 1:], ref[::2, 1:])


GROUPS = ["contiguous", "compact", "chunked/none", "chunked/gzip",
          "chunked/shuffle_gzip", "chunked/fletcher32", "chunked/all",
          "fill", "other"]


@pytest.mark.parametrize("group", GROUPS)
def test_reads_equal_h5py(matrix, group):
    path, names = matrix
    chosen = [n for n in names if n.startswith(group + "/")] or [
        n for n in names if "/" not in n or n.startswith("scalar/")]
    assert chosen
    with hdf5.File(path) as f, h5py.File(path, "r") as ref:
        for name in chosen:
            if ref[name].dtype == h5py.ref_dtype:
                continue
            _all_reads(f[name], ref[name])


def test_references_into_refs_group(matrix):
    path, _ = matrix
    with hdf5.File(path) as f, h5py.File(path, "r") as ref:
        assert "cells" in f and "#refs#/a" in f and "missing" not in f
        assert f.get("missing") is None and f.get("cells") is f["cells"]
        assert f["cells"].shape == (1, 3) and f["cells"].dtype == object
        row, want = f["cells"][0], ref["cells"][0]
        assert len(row) == 3
        for r, w in zip(row, want):
            _same(f[r][:], ref[w][:])
            _same(f[r][()], ref[w][()])
        assert "".join(chr(c[0]) for c in f[row[1]][:]) == "bedroom"
        assert sorted(f["#refs#"].keys()) == ["a", "b", "c"]


def test_deep_group_and_chunk_btrees(tmp_path):
    """300 members make the group's B-tree two levels deep (a node holds
    32 children, a symbol table node 8 members), 12 x 10 chunks the
    chunk index's (a node holds 64); 4-byte addresses and lengths."""
    path = str(tmp_path / "deep.h5")
    fcpl = h5py.h5p.create(h5py.h5p.FILE_CREATE)
    fcpl.set_sizes(4, 4)
    fid = h5py.h5f.create(path.encode(), h5py.h5f.ACC_TRUNC, fcpl=fcpl)
    data = _values("<f4", (47, 39), 5)
    with h5py.File(fid) as f:
        for i in range(300):
            f[f"g/sub/m{i:03d}"] = np.full((2,), i, np.int16)
        f.create_dataset("big", data=data, chunks=(4, 4),
                         compression="gzip")
    with hdf5.File(path) as f, h5py.File(path, "r") as ref:
        assert f._o == f._l == 4
        group, big = f["g/sub"], f["big"]
        for address in (group._btree, big._address):
            assert f._read(address, 8)[5] >= 1  # the root's level
        assert sorted(group.keys()) == sorted(ref["g/sub"].keys())
        for name in ref["g/sub"]:
            _same(f["g"]["sub/" + name][:], ref["g/sub/" + name][:])
        _all_reads(f["/big"], ref["big"])


def test_chunk_cache_reads_a_chunk_once(tmp_path, monkeypatch):
    path = str(tmp_path / "frames.h5")
    data = _values("u1", (6, 5, 4), 3)
    with h5py.File(path, "w") as f:
        f.create_dataset("x", data=data, chunks=(2, 5, 4),
                         compression="gzip")
    inflated = []
    real = hdf5.zlib.decompress
    monkeypatch.setattr(hdf5.zlib, "decompress",
                        lambda b: inflated.append(1) or real(b))
    order = [0, 2, 1, 3, 4, 5, 0]  # chunks 0, 1, 0, 1, 2, 2, 0
    for limit, want in ((hdf5.CHUNK_CACHE_BYTES, 3), (1, 6)):
        # a limit below one chunk keeps the last one only
        monkeypatch.setattr(hdf5, "CHUNK_CACHE_BYTES", limit)
        inflated.clear()
        with hdf5.File(path) as f:
            for i in order:
                _same(f["x"][i], data[i])
        assert len(inflated) == want


def test_chunk_filter_mask_is_obeyed(tmp_path):
    """A chunk whose filter mask skips the pipeline's deflate (as HDF5
    stores a chunk an optional filter failed on) is read raw."""
    path = str(tmp_path / "mask.h5")
    data = _values("<i4", (6, 5), 8)
    with h5py.File(path, "w") as f:
        ds = f.create_dataset("x", data=data, chunks=(3, 5),
                              compression="gzip", shuffle=True)
        raw = np.ascontiguousarray(data[3:] + 1)
        # mask bit 1: the second filter (deflate) skipped, shuffle kept
        shuffled = raw.view(np.uint8).reshape(-1, 4).T.tobytes()
        ds.id.write_direct_chunk((3, 0), shuffled, filter_mask=2)
    with hdf5.File(path) as f, h5py.File(path, "r") as ref:
        _all_reads(f["x"], ref["x"])
        _same(f["x"][3:], raw)


def test_latest_format_is_refused(tmp_path):
    """Read now: a file of `libver='latest'` (superblock 3, an OHDR root
    group with a link message, a compact dataset) equals h5py."""
    path = str(tmp_path / "latest.h5")
    with h5py.File(path, "w", libver="latest") as f:
        f["x"] = np.arange(4)
    with hdf5.File(path) as f, h5py.File(path, "r") as ref:
        assert f._read(0, 9)[8] == 3
        _all_reads(f["x"], ref["x"])


@pytest.mark.parametrize("case", ["lzf", "compound", "vlen_string",
                                  "enum", "soft_link", "ohdr_group"])
def test_uncovered_structures_are_refused(tmp_path, case):
    """Compound, variable-length and enumeration datatypes raise
    `NotPortedError` naming them; lzf chunks, a soft link and a group
    with tracked creation order (a version-2 header) read equal to h5py
    now."""
    path = str(tmp_path / f"{case}.h5")
    with h5py.File(path, "w") as f:
        if case == "lzf":
            f.create_dataset("x", data=np.arange(10), chunks=(5,),
                             compression="lzf")
        elif case == "compound":
            f["x"] = np.zeros(3, [("a", "<i4"), ("b", "<f4")])
        elif case == "vlen_string":
            f.create_dataset("x", data=["a", "bc"],
                             dtype=h5py.string_dtype())
        elif case == "enum":
            f.create_dataset("x", data=np.zeros(3, np.uint8),
                             dtype=h5py.enum_dtype({"a": 0, "b": 1},
                                                   basetype="u1"))
        elif case == "soft_link":
            f["y"] = np.arange(3)
            f["x"] = h5py.SoftLink("/y")
        else:  # tracked creation order needs a version-2 header
            g = f.create_group("x", track_order=True)
            for name in ("b", "a", "c"):
                g[name] = np.arange(len(name) + 2)
    want = {"compound": "compound datatypes",
            "vlen_string": "variable-length datatypes",
            "enum": "enumeration datatypes"}.get(case)
    with hdf5.File(path) as f, h5py.File(path, "r") as ref:
        if want:
            with pytest.raises(NotPortedError, match=want):
                f["x"]
        elif case == "ohdr_group":
            assert f["x"].keys() == list(ref["x"].keys()) == ["b", "a", "c"]
            for name in ref["x"]:
                _all_reads(f["x"][name], ref["x"][name])
        else:
            _all_reads(f["x"], ref["x"])


def test_not_an_hdf5_file(tmp_path):
    path = tmp_path / "x.h5"
    path.write_bytes(b"MATLAB 5.0 MAT-file" + bytes(600))
    with pytest.raises(ValueError, match="not an HDF5 file"):
        hdf5.File(str(path))


def test_fletcher32_mismatch_raises(tmp_path):
    path = str(tmp_path / "f.h5")
    with h5py.File(path, "w") as f:
        f.create_dataset("x", data=np.arange(64, dtype="<i4"), chunks=(64,),
                         fletcher32=True)
    blob = bytearray(open(path, "rb").read())
    at = blob.find(np.arange(64, dtype="<i4").tobytes())
    blob[at + 10] ^= 1
    open(path, "wb").write(bytes(blob))
    with hdf5.File(path) as f:
        with pytest.raises(ValueError, match="fletcher32"):
            f["x"][:]


def test_fletcher32_equals_the_loop():
    """The block-wise sums against HDF5's loop, word by word."""
    def loop(data):
        s1 = s2 = 0
        words = [data[i] << 8 | data[i + 1] for i in range(0, len(data) - 1,
                                                           2)]
        for start in range(0, len(words), 360):
            for w in words[start:start + 360]:
                s1 += w
                s2 += s1
            s1 = (s1 & 0xFFFF) + (s1 >> 16)
            s2 = (s2 & 0xFFFF) + (s2 >> 16)
        if len(data) % 2:
            s1 += data[-1] << 8
            s2 += s1
            s1 = (s1 & 0xFFFF) + (s1 >> 16)
            s2 = (s2 & 0xFFFF) + (s2 >> 16)
        s1 = (s1 & 0xFFFF) + (s1 >> 16)
        s2 = (s2 & 0xFFFF) + (s2 >> 16)
        return s2 << 16 | s1

    rng = np.random.default_rng(0)
    for n in (0, 1, 2, 719, 720, 721, 5000):
        data = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        assert hdf5.fletcher32(data) == loop(data)
    assert hdf5.fletcher32(b"\xff" * 1442) == loop(b"\xff" * 1442)
