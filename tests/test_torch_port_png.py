"""The port's PNG reader and writer (`emsanet_tpu_torch/datasets/png.py`)
against PIL, on the CPU.

`read_png` must return what `np.asarray(PIL.Image.open(path))` returns,
bit for bit, dtype and shape included: gray at 1, 2, 4, 8 and 16 bits,
gray + alpha, RGB and RGBA at 8 bits and palette images at 1, 2, 4 and
8 bits, each written with every PNG row filter (0-4 and a per-row mix),
at an odd width (sub-byte rows end mid-byte), and files PIL writes
itself. JPEG, interlaced and 16-bit colour files raise `NotPortedError`.
"""

import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from emsanet_tpu_torch.config import NotPortedError
from emsanet_tpu_torch.datasets import png

H, W = 7, 13
FILTERS = [0, 1, 2, 3, 4, "adaptive"]
# name: (color type, bit depth, channels)
MODES = {"gray1": (0, 1, 1), "gray2": (0, 2, 1), "gray4": (0, 4, 1),
         "gray8": (0, 8, 1), "gray16": (0, 16, 1), "gray+alpha": (4, 8, 2),
         "rgb": (2, 8, 3), "rgba": (6, 8, 4), "palette1": (3, 1, 1),
         "palette2": (3, 2, 1), "palette4": (3, 4, 1),
         "palette8": (3, 8, 1)}


def _rows(values, depth):
    """(h, w[, c]) samples -> (h, stride) packed big-endian rows."""
    values = values.reshape(values.shape[0], -1)
    if depth == 16:
        return values.astype(">u2").view(np.uint8)
    if depth == 8:
        return values.astype(np.uint8)
    shifts = np.arange(depth - 1, -1, -1)
    bits = ((values[..., None] >> shifts) & 1).reshape(values.shape[0], -1)
    return np.packbits(bits.astype(np.uint8), axis=1)


def _write(path, mode, filter_type, seed=0):
    color, depth, channels = MODES[mode]
    rng = np.random.default_rng(seed)
    shape = (H, W) if channels == 1 else (H, W, channels)
    values = rng.integers(0, 1 << depth, shape)
    palette = (bytes(i % 256 for i in range(3 * (1 << depth))) if color == 3
               else None)
    with open(path, "wb") as fh:
        fh.write(png.encode_png(_rows(values, depth), W, depth, color,
                                palette=palette, filter_type=filter_type))


@pytest.mark.parametrize("mode", list(MODES))
def test_read_png_equals_pil(tmp_path, mode):
    for i, f in enumerate(FILTERS):
        path = str(tmp_path / f"{mode}_{f}.png")
        _write(path, mode, f, seed=i)
        got = png.read_png(path)
        with Image.open(path) as img:
            want = np.asarray(img)
        assert got.dtype == want.dtype and got.shape == want.shape, f
        assert np.array_equal(got, want), f


@pytest.mark.parametrize("pil_mode", ["L", "I;16", "RGB", "RGBA", "P", "1",
                                      "LA"])
def test_read_png_equals_pil_on_files_pil_writes(tmp_path, pil_mode):
    rng = np.random.default_rng(1)
    shape = {"RGB": (31, 45, 3), "RGBA": (31, 45, 4),
             "LA": (31, 45, 2)}.get(pil_mode, (31, 45))
    if pil_mode == "I;16":
        img = Image.fromarray(rng.integers(0, 65536, shape).astype(np.uint16))
    elif pil_mode == "1":
        img = Image.fromarray(rng.integers(0, 2, shape).astype(bool))
    else:
        arr = rng.integers(0, 256, shape).astype(np.uint8)
        # smooth rows so PIL's filter choice varies along the image
        arr[:10] = np.cumsum(arr[:10] % 4, axis=1).astype(np.uint8)
        img = Image.fromarray(arr, "P" if pil_mode == "P" else None)
        if pil_mode == "P":
            img.putpalette(list(range(256)) * 3)
    path = str(tmp_path / "pil.png")
    img.save(path)
    with Image.open(path) as opened:
        want = np.asarray(opened)
    got = png.read_png(path)
    assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("filter_type", FILTERS)
def test_write_png_round_trips_through_pil(tmp_path, filter_type):
    rng = np.random.default_rng(2)
    for arr in (rng.integers(0, 256, (H, W), dtype=np.uint8),
                rng.integers(0, 256, (H, W, 3), dtype=np.uint8),
                rng.integers(0, 256, (H, W, 4), dtype=np.uint8),
                rng.integers(0, 65536, (H, W), dtype=np.uint16)):
        path = str(tmp_path / "w.png")
        png.write_png(path, arr, filter_type)
        with Image.open(path) as img:
            assert np.array_equal(np.asarray(img), arr)
        got = png.read_png(path)
        assert got.dtype == arr.dtype and np.array_equal(got, arr)


def test_transparency_chunk_is_ignored_as_pil_does(tmp_path):
    path = str(tmp_path / "trns.png")
    _write(path, "palette8", 4)
    blob = open(path, "rb").read()
    at = blob.index(b"IDAT") - 4
    trns = (struct.pack(">I", 2) + b"tRNS\x00\x80"
            + struct.pack(">I", zlib.crc32(b"tRNS\x00\x80") & 0xFFFFFFFF))
    open(path, "wb").write(blob[:at] + trns + blob[at:])
    with Image.open(path) as img:
        want = np.asarray(img)
    assert np.array_equal(png.read_png(path), want)


def test_unported_files_raise(tmp_path):
    jpg = str(tmp_path / "rgb.jpg")
    Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(jpg)
    with pytest.raises(NotPortedError, match="JPEG.*rgb.jpg"):
        png.read_png(jpg)
    laced = str(tmp_path / "laced.png")
    blob = png.encode_png(np.zeros((H, W), np.uint8), W, 8, 0)
    header = blob[16:28] + b"\x01"  # IHDR with the interlace byte set
    with open(laced, "wb") as fh:
        fh.write(blob[:8] + blob[8:16] + header + struct.pack(
            ">I", zlib.crc32(blob[12:28] + b"\x01") & 0xFFFFFFFF)
            + blob[33:])
    with pytest.raises(NotPortedError, match="interlaced.*laced.png"):
        png.read_png(laced)
    rgb16 = str(tmp_path / "rgb16.png")
    with open(rgb16, "wb") as fh:
        fh.write(png.encode_png(np.zeros((H, 6 * W), np.uint8), W, 16, 2))
    with pytest.raises(NotPortedError, match="color type 2 at 16"):
        png.read_png(rgb16)
    text = tmp_path / "x.png"
    text.write_text("not a png")
    with pytest.raises(ValueError, match="not a PNG"):
        png.read_png(str(text))


def test_unknown_filter_type_raises():
    stream = bytearray(png.filter_rows(np.zeros((3, 5), np.uint8), 1, 0))
    stream[6] = 5  # the second row's filter byte
    with pytest.raises(ValueError, match="filter type 5 in row 1"):
        png.native.png_unfilter(bytes(stream), 3, 5, 1)
