"""Host-side image operations that the JAX package's scripts take from
PIL: the bicubic resize of `Image.resize`, and line and text drawing for
the orientation overlay. numpy only; the card's machine has no PIL.

`resize_bicubic_u8(img, h, w)` is `np.asarray(Image.fromarray(img).
resize((w, h)))` for uint8 (H, W) and (H, W, C) images: PIL's default
filter for RGB, bicubic (a = -0.5) with its support widened by the scale
when downscaling, one pass per axis (width first) in PIL's fixed-point
arithmetic (22 fraction bits, coefficients rounded half away from zero,
each pass rounded and clipped to uint8). An image of the asked size
comes back as an unchanged copy. `resize_bilinear_u8` is the same with
PIL's BILINEAR filter (the triangle, support 1 widened by the scale).
`resize_nearest(img, h, w)` is PIL's NEAREST resize: the source pixel
floor((x + 0.5) * scale), computed as PIL computes it for the array's
mode (an accumulated position for 8-bit images, a direct product for
16-bit ones, which PIL resamples on another path).

`draw_line` fills the pixels whose centres lie within (width - 1) / 2 +
0.5 of the segment and between its ends, with the ends truncated to
integers as PIL's wide lines take them; PIL fills a polygon of nearly
the same rectangle, so the two differ in single pixels along the edges.
`draw_text` writes the digits and '°' in a built-in 5x7 bitmap font,
scaled by an integer; PIL's default font is a TrueType one, so the
glyphs are the port's own.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np

_PRECISION_BITS = 32 - 8 - 2  # PIL's 8-bit resampling


def _bicubic(x: np.ndarray) -> np.ndarray:
    a = -0.5
    x = np.abs(x)
    return np.where(x < 1.0, ((a + 2.0) * x - (a + 3.0)) * x * x + 1,
                    np.where(x < 2.0, (((x - 5) * x + 8) * x - 4) * a, 0.0))


def _bilinear(x: np.ndarray) -> np.ndarray:
    x = np.abs(x)
    return np.where(x < 1.0, 1.0 - x, 0.0)


_FILTERS = {"bicubic": (_bicubic, 2.0), "bilinear": (_bilinear, 1.0)}


def _coefficients(in_size: int, out_size: int, kind: str = "bicubic"
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """(taps (out, k) source indices, fixed-point weights (out, k)) of
    one axis, as PIL's `precompute_coeffs` and `normalize_coeffs_8bpc`."""
    kernel, filter_support = _FILTERS[kind]
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = filter_support * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    center = (np.arange(out_size) + 0.5) * scale
    xmin = np.maximum((center - support + 0.5).astype(np.int64), 0)
    xmax = np.minimum((center + support + 0.5).astype(np.int64),
                      in_size) - xmin
    offs = np.arange(ksize)
    used = offs[None, :] < xmax[:, None]
    w = kernel((offs[None, :] + xmin[:, None] - center[:, None] + 0.5)
               / filterscale) * used
    total = w.sum(1, keepdims=True)
    w = np.where(total != 0.0, w / np.where(total != 0.0, total, 1.0), w)
    w = w * (1 << _PRECISION_BITS)
    k = np.trunc(np.where(w < 0, w - 0.5, w + 0.5)).astype(np.int64)
    taps = np.minimum(xmin[:, None] + offs[None, :], in_size - 1)
    return taps, np.where(used, k, 0)


def _resample_axis(img: np.ndarray, out_size: int, axis: int,
                   kind: str = "bicubic") -> np.ndarray:
    taps, k = _coefficients(img.shape[axis], out_size, kind)
    shape = [1] * img.ndim
    shape[axis] = out_size
    acc = np.full(img.shape[:axis] + (out_size,) + img.shape[axis + 1:],
                  1 << (_PRECISION_BITS - 1), np.int64)
    for t in range(taps.shape[1]):
        acc += (np.take(img, taps[:, t], axis=axis).astype(np.int64)
                * k[:, t].reshape(shape))
    return np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)


def _resize_u8(img: np.ndarray, height: int, width: int,
               kind: str) -> np.ndarray:
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim not in (2, 3):
        raise ValueError(f"resize_{kind}_u8: uint8 (H, W[, C]) expected, "
                         f"got {img.dtype} {img.shape}")
    out = img
    if width != img.shape[1]:
        out = _resample_axis(out, width, 1, kind)
    if height != img.shape[0]:
        out = _resample_axis(out, height, 0, kind)
    return out.copy() if out is img else out


def resize_bicubic_u8(img: np.ndarray, height: int, width: int
                      ) -> np.ndarray:
    """PIL's `Image.resize((width, height))` of a uint8 image."""
    return _resize_u8(img, height, width, "bicubic")


def resize_bilinear_u8(img: np.ndarray, height: int, width: int
                       ) -> np.ndarray:
    """PIL's `Image.resize((width, height), Image.BILINEAR)` of a uint8
    image."""
    return _resize_u8(img, height, width, "bilinear")


def _nearest_taps(in_size: int, out_size: int, accumulate: bool
                  ) -> np.ndarray:
    scale = in_size / out_size
    if not accumulate:  # PIL's affine_transform + nearest_filter16
        return np.array([int(scale * (i + 0.5)) for i in range(out_size)])
    taps, pos = [], scale * 0.5  # PIL's ImagingScaleAffine
    for _ in range(out_size):
        taps.append(int(pos))
        pos += scale
    return np.minimum(np.array(taps), in_size - 1)


def resize_nearest(img: np.ndarray, height: int, width: int) -> np.ndarray:
    """PIL's `Image.fromarray(img).resize((width, height), Image.NEAREST)`
    of a uint8 or uint16 (H, W[, C]) image."""
    img = np.asarray(img)
    if img.shape[:2] == (height, width):
        return img.copy()
    accumulate = img.dtype != np.uint16
    rows = _nearest_taps(img.shape[0], height, accumulate)
    cols = _nearest_taps(img.shape[1], width, accumulate)
    return img[rows[:, None], cols[None, :]]


def draw_line(img: np.ndarray, p0: Sequence[float], p1: Sequence[float],
              color: Sequence[int], width: int = 1) -> None:
    """Draw the segment p0 -> p1 ((x, y) pixel coordinates) `width`
    pixels wide into the (H, W, C) image `img`, in place."""
    x0, y0, x1, y1 = (int(v) for v in (*p0, *p1))  # truncated, as PIL
    half = (width - 1) / 2.0 + 0.5
    pad = int(math.ceil(half))
    h, w = img.shape[:2]
    xa, xb = max(min(x0, x1) - pad, 0), min(max(x0, x1) + pad, w - 1)
    ya, yb = max(min(y0, y1) - pad, 0), min(max(y0, y1) + pad, h - 1)
    if xa > xb or ya > yb:
        return
    yy, xx = np.mgrid[ya:yb + 1, xa:xb + 1].astype(np.float64)
    dx, dy = float(x1 - x0), float(y1 - y0)
    length = math.hypot(dx, dy)
    if length == 0.0:
        inside = (np.abs(xx - x0) < half) & (np.abs(yy - y0) < half)
    else:
        ux, uy = dx / length, dy / length
        along = (xx - x0) * ux + (yy - y0) * uy
        across = (xx - x0) * uy - (yy - y0) * ux
        inside = (np.abs(across) < half) & (along >= -0.5) & (
            along <= length + 0.5)
    img[ya:yb + 1, xa:xb + 1][inside] = np.asarray(color, img.dtype)


# 5x7 glyphs, one string of 7 rows per character ('°' is 4 wide)
_GLYPHS = {
    "0": ("01110", "10001", "10011", "10101", "11001", "10001", "01110"),
    "1": ("00100", "01100", "00100", "00100", "00100", "00100", "01110"),
    "2": ("01110", "10001", "00001", "00010", "00100", "01000", "11111"),
    "3": ("11111", "00010", "00100", "00010", "00001", "10001", "01110"),
    "4": ("00010", "00110", "01010", "10010", "11111", "00010", "00010"),
    "5": ("11111", "10000", "11110", "00001", "00001", "10001", "01110"),
    "6": ("00110", "01000", "10000", "11110", "10001", "10001", "01110"),
    "7": ("11111", "00001", "00010", "00100", "01000", "01000", "01000"),
    "8": ("01110", "10001", "10001", "01110", "10001", "10001", "01110"),
    "9": ("01110", "10001", "10001", "01111", "00001", "00010", "01100"),
    "°": ("0110", "1001", "1001", "0110", "0000", "0000", "0000"),
}
GLYPH_HEIGHT = 7


def _glyph(ch: str) -> np.ndarray:
    return np.array([[c == "1" for c in row] for row in _GLYPHS[ch]], bool)


def draw_text(img: np.ndarray, xy: Sequence[float], text: str,
              color: Sequence[int], scale: int = 1) -> None:
    """Write `text` (digits and '°') with its top-left corner at `xy`
    ((x, y), truncated), each font pixel a `scale` x `scale` square and
    one font pixel between glyphs, into the (H, W, C) image, in place."""
    x, y = int(xy[0]), int(xy[1])
    h, w = img.shape[:2]
    value = np.asarray(color, img.dtype)
    for ch in text:
        mask = np.kron(_glyph(ch), np.ones((scale, scale), bool))
        gh, gw = mask.shape
        ya, xa = max(y, 0), max(x, 0)
        yb, xb = min(y + gh, h), min(x + gw, w)
        if ya < yb and xa < xb:
            img[ya:yb, xa:xb][mask[ya - y:yb - y, xa - x:xb - x]] = value
        x += gw + scale
