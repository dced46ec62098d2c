"""JPEG files without an image library: the loader's and the dataset
preparation's reader.

`read_jpeg(path)` returns what `np.asarray(PIL.Image.open(path))` returns
for an 8-bit file of any coding PIL (libjpeg-turbo 3) decodes: baseline,
extended and progressive Huffman, arithmetic-coded sequential and
progressive, and lossless: (h, w) uint8 for one component, (h, w, 3)
uint8 RGB for three, (h, w, 4) uint8 CMYK for four (inverted, as PIL's
mode CMYK holds them; YCCK converted). The frame header is read here;
the entropy decoding, the lossless prediction, the IDCT with
libjpeg-turbo's block smoothing of partly coded progressive files, the
chroma upsampling and the colour conversion run in the host library
(`csrc/host/jpeg_baseline.h`, `jpeg_arith.h`, `jpeg_lossless.h`:
libjpeg-turbo's integer IDCT, fancy upsampling and YCbCr tables, as
Pillow decodes). 12-bit, hierarchical and arithmetic-coded lossless
files, which PIL refuses too, and other component counts raise
`NotPortedError` naming the file; a lossless file in YCbCr or YCCK
raises ValueError, as PIL does.
"""

from __future__ import annotations

import struct
from typing import Tuple

import numpy as np

from emsanet_tpu_torch import native
from emsanet_tpu_torch.config import NotPortedError

SOI = b"\xff\xd8\xff"
_SOF_NAMES = {0xC5: "differential sequential", 0xC6: "differential "
              "progressive", 0xC7: "differential lossless",
              0xC9: "arithmetic-coded sequential", 0xCA: "arithmetic-coded "
              "progressive", 0xCB: "arithmetic-coded lossless",
              0xCD: "arithmetic-coded differential sequential",
              0xCE: "arithmetic-coded differential progressive",
              0xCF: "arithmetic-coded differential lossless"}


def frame_header(blob: bytes, name: str = "JPEG data"
                 ) -> Tuple[int, int, int]:
    """(width, height, components) of a baseline, extended sequential,
    progressive or lossless frame, Huffman or arithmetic-coded; raise
    `NotPortedError` for any other coding."""
    if not blob.startswith(SOI):
        raise ValueError(f"{name} is not a JPEG file")
    pos = 2
    while pos + 4 <= len(blob):
        if blob[pos] != 0xFF:
            pos += 1
            continue
        marker = blob[pos + 1]
        if marker == 0xFF:
            pos += 1
            continue
        if marker in (0xD8, 0x01) or 0xD0 <= marker <= 0xD7:
            pos += 2
            continue
        (length,) = struct.unpack(">H", blob[pos + 2:pos + 4])
        if marker in (0xC0, 0xC1, 0xC2, 0xC3, 0xC9, 0xCA):
            precision, height, width, n = struct.unpack(
                ">BHHB", blob[pos + 4:pos + 10])
            if precision != 8:
                raise NotPortedError(f"not ported yet: {precision}-bit JPEG "
                                     f"files ({name})")
            if n not in (1, 3, 4):
                raise NotPortedError(f"not ported yet: JPEG files of {n} "
                                     f"components ({name})")
            return width, height, n
        if marker in _SOF_NAMES:
            raise NotPortedError(f"not ported yet: {_SOF_NAMES[marker]} "
                                 f"JPEG files ({name})")
        if marker in (0xD9, 0xDA):
            break
        pos += 2 + length
    raise ValueError(f"{name}: no JPEG frame header")


def decode_jpeg(blob: bytes, name: str = "JPEG data") -> np.ndarray:
    """The pixels of the JPEG file `blob`, as PIL gives them."""
    width, height, n = frame_header(blob, name)
    try:
        return native.jpeg_decode(blob, width, height, n)
    except NotPortedError as e:
        raise NotPortedError(f"not ported yet: {e} ({name})") from None
    except ValueError as e:
        raise ValueError(f"{name}: {e}") from None


def read_jpeg(path: str) -> np.ndarray:
    with open(path, "rb") as fh:
        return decode_jpeg(fh.read(), path)
