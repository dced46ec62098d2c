"""PNG files without an image library: the loader's reader and the
writer of the port's test and smoke datasets.

`read_png(path)` parses the chunks, inflates the IDAT stream with
`zlib`, undoes the row filters in the host library
(`native.png_unfilter`) and returns what `np.asarray(PIL.Image.open(p))`
returns for the same file:
  gray 8 bit             (h, w) uint8
  gray 16 bit            (h, w) uint16 (big-endian on disk; PIL's 'I;16')
  gray 1 bit             (h, w) bool (PIL's mode '1')
  gray 2 and 4 bit       (h, w) uint8 scaled to 0..255 (PIL's 'L')
  gray + alpha 8 bit     (h, w, 2) uint8
  RGB / RGBA 8 bit       (h, w, 3) / (h, w, 4) uint8
  palette 1, 2, 4, 8 bit (h, w) uint8 of raw indices (PIL's mode 'P')
Interlaced files, other depths and JPEG files raise `NotPortedError`
naming the file. Ancillary chunks (tRNS, gAMA, ...) are ignored, as
`np.asarray` of the opened image ignores them.

`write_png(path, arr)` writes uint8 gray / RGB / RGBA and uint16 gray
arrays, each row with filter 0 (the counterpart of
`tools/prepare_dataset.py::_save_png`), or with `filter_type` 1-4 or
'adaptive' (per row, the filter with the least sum of absolute signed
bytes, as libpng chooses).
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import Optional, Union

import numpy as np

from emsanet_tpu_torch import native
from emsanet_tpu_torch.config import NotPortedError

SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}  # by color type
# (color type, bit depth) the reader decodes
_SUPPORTED = {(0, 1), (0, 2), (0, 4), (0, 8), (0, 16), (2, 8), (3, 1),
              (3, 2), (3, 4), (3, 8), (4, 8), (6, 8)}


def read_png(path: str) -> np.ndarray:
    """The pixels of a non-interlaced PNG file, as PIL gives them."""
    with open(path, "rb") as fh:
        blob = fh.read()
    if not blob.startswith(SIGNATURE):
        if blob[:3] == b"\xff\xd8\xff":
            raise NotPortedError(f"not ported yet: JPEG files ({path})")
        raise ValueError(f"{path} is not a PNG file")
    pos, header, idat = len(SIGNATURE), None, []
    while pos + 8 <= len(blob):
        length, tag = struct.unpack(">I4s", blob[pos:pos + 8])
        data = blob[pos + 8:pos + 8 + length]
        pos += 12 + length
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", data)
        elif tag == b"IDAT":
            idat.append(data)
        elif tag == b"IEND":
            break
    if header is None or not idat:
        raise ValueError(f"{path}: no IHDR or IDAT chunk")
    width, height, depth, color_type, _, _, interlace = header
    if interlace:
        raise NotPortedError(f"not ported yet: interlaced PNG files "
                             f"({path})")
    if (color_type, depth) not in _SUPPORTED:
        raise NotPortedError(f"not ported yet: PNG color type {color_type} "
                             f"at {depth} bits ({path})")
    channels = _CHANNELS[color_type]
    bits = channels * depth
    stride = (width * bits + 7) // 8
    rows = native.png_unfilter(zlib.decompress(b"".join(idat)), height,
                               stride, max(bits // 8, 1))
    if depth == 16:
        return rows.view(">u2").astype(np.uint16).reshape(height, width)
    if depth == 8:
        shape = (height, width) if channels == 1 else (height, width,
                                                       channels)
        return rows.reshape(shape)
    # 1, 2, 4 bits: one sample per `depth` bits, most significant first
    unpacked = np.unpackbits(rows, axis=1).reshape(height, -1, depth)
    weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
    values = (unpacked * weights).sum(-1, dtype=np.uint8)[:, :width]
    if color_type == 3:
        return values
    if depth == 1:
        return values.astype(bool)
    return values * np.uint8(255 // ((1 << depth) - 1))


def _paeth(a, b, c):
    a, b, c = (x.astype(np.int16) for x in (a, b, c))
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a,
                    np.where(pb <= pc, b, c)).astype(np.uint8)


def filter_rows(raw: np.ndarray, bpp: int,
                filter_type: Union[int, str] = 0) -> bytes:
    """PNG-filter (h, stride) uint8 rows: the IDAT stream before zlib."""
    raw = np.ascontiguousarray(raw, np.uint8)
    left = np.zeros_like(raw)
    left[:, bpp:] = raw[:, :-bpp]
    up = np.zeros_like(raw)
    up[1:] = raw[:-1]
    upleft = np.zeros_like(raw)
    upleft[1:] = left[:-1]
    candidates = np.stack([
        raw, raw - left, raw - up,
        raw - ((left.astype(np.uint16) + up) >> 1).astype(np.uint8),
        raw - _paeth(left, up, upleft)])  # (5, h, stride), wraps mod 256
    if filter_type == "adaptive":
        cost = np.abs(candidates.view(np.int8).astype(np.int32)).sum(-1)
        types = cost.argmin(0).astype(np.uint8)
    elif filter_type in range(5):
        types = np.full(raw.shape[0], filter_type, np.uint8)
    else:
        raise ValueError(f"unknown PNG filter type {filter_type!r}")
    rows = candidates[types, np.arange(raw.shape[0])]
    return np.concatenate([types[:, None], rows], axis=1).tobytes()


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def encode_png(raw: np.ndarray, width: int, depth: int, color_type: int,
               palette: Optional[bytes] = None,
               filter_type: Union[int, str] = 0) -> bytes:
    """A PNG file of (h, stride) packed rows of `depth`-bit samples."""
    bits = _CHANNELS[color_type] * depth
    header = struct.pack(">IIBBBBB", width, raw.shape[0], depth,
                         color_type, 0, 0, 0)
    stream = filter_rows(raw, max(bits // 8, 1), filter_type)
    return (SIGNATURE + _chunk(b"IHDR", header)
            + (_chunk(b"PLTE", palette) if palette is not None else b"")
            + _chunk(b"IDAT", zlib.compress(stream))
            + _chunk(b"IEND", b""))


def write_png(path: str, arr: np.ndarray,
              filter_type: Union[int, str] = 0) -> None:
    """Write uint8 (h, w), (h, w, 3), (h, w, 4) or uint16 (h, w)."""
    arr = np.asarray(arr)
    if arr.dtype == np.uint16 and arr.ndim == 2:
        raw, depth, color_type = arr.astype(">u2").view(np.uint8), 16, 0
    elif arr.dtype == np.uint8 and arr.ndim == 2:
        raw, depth, color_type = arr, 8, 0
    elif arr.dtype == np.uint8 and arr.ndim == 3 and arr.shape[2] in (3, 4):
        raw, depth = arr.reshape(arr.shape[0], -1), 8
        color_type = 2 if arr.shape[2] == 3 else 6
    else:
        raise ValueError(f"write_png: unsupported array {arr.dtype} "
                         f"{arr.shape}")
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as fh:
        fh.write(encode_png(raw, arr.shape[1], depth, color_type,
                            filter_type=filter_type))
