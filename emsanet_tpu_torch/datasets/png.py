"""PNG files without an image library: the loader's reader and the
writer of the port's datasets.

`read_png(path)` parses the chunks, inflates the IDAT stream with
`zlib`, undoes the row filters in the host library
(`native.png_unfilter`), for an interlaced file pass by pass (Adam7),
and returns what `np.asarray(PIL.Image.open(p))` returns for the same
file:
  gray 8 bit             (h, w) uint8
  gray 16 bit            (h, w) uint16 (big-endian on disk; PIL's 'I;16')
  gray 1 bit             (h, w) bool (PIL's mode '1')
  gray 2 and 4 bit       (h, w) uint8 scaled to 0..255 (PIL's 'L')
  gray + alpha 8 bit     (h, w, 2) uint8
  gray + alpha 16 bit    (h, w, 4) uint8 (PIL's RGBA: gray, gray, gray,
                         alpha)
  RGB / RGBA 8 / 16 bit  (h, w, 3) / (h, w, 4) uint8
  palette 1, 2, 4, 8 bit (h, w) uint8 of raw indices (PIL's mode 'P')
PIL keeps the high byte of a 16-bit colour or alpha sample, and so does
this reader. A JPEG file given to it is decoded by `datasets/jpeg.py`
(as PIL opens either), which refuses progressive and CMYK files.
`decode_image(blob, name)` does the same for the bytes of a file, and
with `rgb=True` returns what PIL's `.convert("RGB")` gives: gray
replicated, alpha dropped, a palette looked up (16-bit gray refused).
Ancillary chunks (tRNS, gAMA, ...) are ignored, as `np.asarray` of the
opened image ignores them.

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
from emsanet_tpu_torch.datasets import jpeg

SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}  # by color type
# (color type, bit depth) that PNG allows
_SUPPORTED = {(0, 1), (0, 2), (0, 4), (0, 8), (0, 16), (2, 8), (2, 16),
              (3, 1), (3, 2), (3, 4), (3, 8), (4, 8), (4, 16), (6, 8),
              (6, 16)}
# Adam7: (x0, y0, dx, dy) of each pass
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def read_png(path: str) -> np.ndarray:
    """The pixels of a PNG (or JPEG) file, as PIL gives them."""
    with open(path, "rb") as fh:
        return decode_image(fh.read(), path)


def read_rgb(path: str) -> np.ndarray:
    """`np.asarray(PIL.Image.open(path).convert("RGB"))`."""
    with open(path, "rb") as fh:
        return decode_image(fh.read(), path, rgb=True)


def decode_image(blob: bytes, name: str = "image data",
                 rgb: bool = False) -> np.ndarray:
    """The pixels of the PNG or JPEG file `blob`, as PIL gives them (with
    `rgb`, converted to RGB as PIL converts)."""
    if blob.startswith(jpeg.SOI):
        img = jpeg.decode_jpeg(blob, name)
        return np.repeat(img[..., None], 3, -1) if rgb and img.ndim == 2 \
            else img
    if not blob.startswith(SIGNATURE):
        raise ValueError(f"{name} is not a PNG file")
    img, color_type, palette = _decode_png(blob, name)
    if not rgb:
        return img
    if color_type == 3:
        table = np.frombuffer(palette or b"", np.uint8).reshape(-1, 3)
        table = np.concatenate([table, np.zeros((256 - len(table), 3),
                                                np.uint8)])
        return table[img]
    if img.dtype == np.uint16:
        raise NotPortedError(f"not ported yet: 16-bit gray to RGB ({name})")
    if img.dtype == bool:
        img = img.astype(np.uint8) * np.uint8(255)
    if img.ndim == 2:
        return np.repeat(img[..., None], 3, -1)
    if img.shape[-1] == 2:  # gray + alpha
        return np.repeat(img[..., :1], 3, -1)
    return np.ascontiguousarray(img[..., :3])


def _decode_png(blob: bytes, path: str):
    """(pixels as PIL gives them, color type, PLTE bytes or None)."""
    pos, header, idat, palette = len(SIGNATURE), None, [], None
    while pos + 8 <= len(blob):
        length, tag = struct.unpack(">I4s", blob[pos:pos + 8])
        data = blob[pos + 8:pos + 8 + length]
        pos += 12 + length
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", data)
        elif tag == b"IDAT":
            idat.append(data)
        elif tag == b"PLTE":
            palette = data
        elif tag == b"IEND":
            break
    if header is None or not idat:
        raise ValueError(f"{path}: no IHDR or IDAT chunk")
    width, height, depth, color_type, _, _, interlace = header
    if (color_type, depth) not in _SUPPORTED or interlace > 1:
        raise ValueError(f"{path}: invalid PNG color type {color_type} at "
                         f"{depth} bits, or interlace method {interlace}")
    channels = _CHANNELS[color_type]
    stream = zlib.decompress(b"".join(idat))
    if not interlace:
        samples = _samples(stream, width, height, depth, channels)
    else:
        samples = np.zeros((height, width, channels),
                           np.uint16 if depth == 16 else np.uint8)
        pos = 0
        for x0, y0, dx, dy in _ADAM7:
            w = (width - x0 + dx - 1) // dx
            h = (height - y0 + dy - 1) // dy
            if w <= 0 or h <= 0:
                continue  # an empty pass has no rows at all
            size = h * (1 + (w * channels * depth + 7) // 8)
            samples[y0::dy, x0::dx] = _samples(stream[pos:pos + size], w, h,
                                               depth, channels)
            pos += size
    if depth == 16:
        if channels == 1:
            return samples[..., 0], color_type, palette
        high = (samples >> 8).astype(np.uint8)  # PIL's 'RGB;16B' etc.
        if channels == 2:  # PIL opens it as RGBA: L, L, L, A
            return high[..., [0, 0, 0, 1]], color_type, palette
        return high, color_type, palette
    if channels > 1:
        return samples, color_type, palette
    values = samples[..., 0]
    if depth == 8 or color_type == 3:
        return values, color_type, palette
    if depth == 1:
        return values.astype(bool), color_type, palette
    return (values * np.uint8(255 // ((1 << depth) - 1)), color_type,
            palette)


def _samples(stream: bytes, width: int, height: int, depth: int,
             channels: int) -> np.ndarray:
    """(height, width, channels) samples of a filtered image (or pass):
    uint16 at 16 bits, else uint8 (1, 2, 4 bits: the raw values)."""
    bits = channels * depth
    stride = (width * bits + 7) // 8
    rows = native.png_unfilter(stream, height, stride, max(bits // 8, 1))
    if depth == 16:
        return rows.view(">u2").astype(np.uint16).reshape(height, width,
                                                          channels)
    if depth == 8:
        return rows.reshape(height, width, channels)
    # 1, 2, 4 bits: one sample per `depth` bits, most significant first
    unpacked = np.unpackbits(rows, axis=1).reshape(height, -1, depth)
    weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
    values = (unpacked * weights).sum(-1, dtype=np.uint8)[:, :width]
    return values[..., None]


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
    """Write uint8 (h, w), (h, w, 3), (h, w, 4) or uint16 (h, w), in any
    memory layout."""
    arr = np.ascontiguousarray(arr)
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
