"""ctypes bindings of the port's native host library.

`csrc/host/emsanet_native.cpp`, a copy of the JAX package's host library
plus the PNG reader's row unfiltering and the baseline JPEG decoder
(`csrc/host/jpeg_baseline.h`), is compiled at first use with the
JAX package's flags (`g++ -O3 -march=native -ffast-math -fPIC`, linked
without `-ffast-math`: at link time it would pull in `crtfastmath.o`,
which sets FTZ/DAZ for the whole process) into
`build/host/libemsanet_native-<hash>.so` inside the checkout. The hash
covers the source and the headers beside it, the flags and this
machine's CPU, so an edited source,
or a checkout copied to another machine, is rebuilt. There is no switch
and no numpy fallback: a failed build raises with the compiler's
message. Each entry point takes and returns numpy arrays; the numpy
bodies of `preprocessing/transforms.py` are the plain versions the tests
hold these against. A ctypes call releases the GIL, so worker threads
run these in parallel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional

import numpy as np

SOURCE = (Path(__file__).resolve().parent / "csrc" / "host"
          / "emsanet_native.cpp")
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "host"
COMPILE_FLAGS = ["-O3", "-march=native", "-ffast-math", "-fPIC"]
LINK_FLAGS = ["-shared"]

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()


def _cpu_signature() -> bytes:
    """The CPU's model and flags (what -march=native compiles for)."""
    try:
        with open("/proc/cpuinfo", "rb") as fh:
            lines = fh.read().split(b"\n\n")[0].splitlines()
    except OSError:
        return b""
    return b"\n".join(l for l in lines
                      if l.startswith((b"model name", b"flags")))


def library_path() -> Path:
    headers = b"".join(p.read_bytes()
                       for p in sorted(SOURCE.parent.glob("*.h")))
    digest = hashlib.sha256(
        SOURCE.read_bytes() + headers
        + " ".join(COMPILE_FLAGS + LINK_FLAGS).encode()
        + _cpu_signature()).hexdigest()[:16]
    return BUILD_DIR / f"libemsanet_native-{digest}.so"


def _build(out: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    obj = tmp.with_suffix(".o")
    try:
        for cmd in (["g++", *COMPILE_FLAGS, "-c", "-o", str(obj),
                     str(SOURCE)],
                    ["g++", *LINK_FLAGS, "-o", str(tmp), str(obj)]):
            try:
                proc = subprocess.run(cmd, capture_output=True, text=True,
                                      timeout=300)
            except FileNotFoundError as e:
                raise RuntimeError(
                    f"the host library cannot be built: {e}") from e
            if proc.returncode != 0:
                raise RuntimeError(
                    f"building the host library failed ({' '.join(cmd)}):"
                    f"\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)  # atomic: a concurrent build replaces it whole
    finally:
        for p in (obj, tmp):
            if p.exists():
                p.unlink()


def get_lib() -> ctypes.CDLL:
    """The loaded host library, built on first use."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is not None:
            return _lib
        path = library_path()
        if not path.exists():
            _build(path)
        lib = ctypes.CDLL(str(path))
        f32p = ctypes.POINTER(ctypes.c_float)
        i32p = ctypes.POINTER(ctypes.c_int32)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        c_int, c_i64, c_f = ctypes.c_int, ctypes.c_int64, ctypes.c_float
        signatures: Dict[str, list] = {
            "instance_targets": [i32p, i32p, u8p, c_int, c_int, c_int, c_f,
                                 c_int, f32p, f32p, u8p, u8p],
            "resize_nearest_i32": [i32p, c_int, c_int, i32p, c_int, c_int],
            "resize_bilinear_f32": [f32p, c_int, c_int, c_int, f32p, c_int,
                                    c_int],
            "resize_bilinear_u8": [u8p, c_int, c_int, c_int, u8p, c_int,
                                   c_int],
            "normalize_rgb_u8": [u8p, c_i64, f32p, f32p, f32p],
            "hsv_jitter_u8": [u8p, c_i64, c_f, c_f, c_f, u8p],
            "png_unfilter": [u8p, c_i64, c_i64, c_int, u8p],
            "jpeg_decode": [u8p, c_i64, c_int, c_int, c_int, u8p],
        }
        for name, argtypes in signatures.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = (c_int if name in ("png_unfilter", "jpeg_decode")
                          else None)
        _lib = lib
        return lib


def _ptr(arr: np.ndarray, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def instance_targets(semantic: np.ndarray, instance: np.ndarray,
                     is_thing: np.ndarray, sigma: float,
                     normalized_offset: bool) -> Dict[str, np.ndarray]:
    """Center heatmap, offsets, foreground and the heatmap loss mask."""
    lib = get_lib()
    h, w = instance.shape
    semantic = np.ascontiguousarray(semantic, np.int32)
    instance = np.ascontiguousarray(instance, np.int32)
    is_thing_u8 = np.ascontiguousarray(is_thing, np.uint8)
    center = np.empty((h, w), np.float32)
    offset = np.empty((h, w, 2), np.float32)
    foreground = np.empty((h, w), np.uint8)
    center_mask = np.empty((h, w), np.uint8)
    lib.instance_targets(
        _ptr(semantic, ctypes.c_int32), _ptr(instance, ctypes.c_int32),
        _ptr(is_thing_u8, ctypes.c_uint8), len(is_thing_u8), h, w,
        float(sigma), int(normalized_offset),
        _ptr(center, ctypes.c_float), _ptr(offset, ctypes.c_float),
        _ptr(foreground, ctypes.c_uint8), _ptr(center_mask, ctypes.c_uint8))
    return {
        "instance_center": center[..., None],
        "instance_offset": offset,
        "instance_foreground": foreground.astype(bool),
        "instance_center_mask": center_mask.astype(bool),
    }


def resize_nearest_i32(src: np.ndarray, oh: int, ow: int) -> np.ndarray:
    lib = get_lib()
    src = np.ascontiguousarray(src, np.int32)
    ih, iw = src.shape
    dst = np.empty((oh, ow), np.int32)
    lib.resize_nearest_i32(_ptr(src, ctypes.c_int32), ih, iw,
                           _ptr(dst, ctypes.c_int32), oh, ow)
    return dst


def _resize_hwc(fn, src: np.ndarray, dtype, ctype, oh: int, ow: int):
    squeeze = src.ndim == 2
    if squeeze:
        src = src[..., None]
    src = np.ascontiguousarray(src, dtype)
    ih, iw, c = src.shape
    dst = np.empty((oh, ow, c), dtype)
    fn(_ptr(src, ctype), ih, iw, c, _ptr(dst, ctype), oh, ow)
    return dst[..., 0] if squeeze else dst


def resize_bilinear_f32(src: np.ndarray, oh: int, ow: int) -> np.ndarray:
    """Bilinear resize of (h, w) or (h, w, c) float32, half-pixel
    centers."""
    return _resize_hwc(get_lib().resize_bilinear_f32, src, np.float32,
                       ctypes.c_float, oh, ow)


def resize_bilinear_u8(src: np.ndarray, oh: int, ow: int) -> np.ndarray:
    """Bilinear resize of uint8 rounding half to even, as np.round: one
    pass in place of astype(f32) -> resize -> round -> astype(u8)."""
    return _resize_hwc(get_lib().resize_bilinear_u8, src, np.uint8,
                       ctypes.c_uint8, oh, ow)


def normalize_rgb(rgb_u8: np.ndarray, mean: np.ndarray,
                  std: np.ndarray) -> np.ndarray:
    lib = get_lib()
    rgb_u8 = np.ascontiguousarray(rgb_u8, np.uint8)
    mean = np.ascontiguousarray(mean, np.float32)
    std = np.ascontiguousarray(std, np.float32)
    out = np.empty(rgb_u8.shape, np.float32)
    lib.normalize_rgb_u8(
        _ptr(rgb_u8, ctypes.c_uint8), rgb_u8.shape[0] * rgb_u8.shape[1],
        _ptr(mean, ctypes.c_float), _ptr(std, ctypes.c_float),
        _ptr(out, ctypes.c_float))
    return out


def hsv_jitter(rgb_u8: np.ndarray, dh: float, ds: float,
               dv: float) -> np.ndarray:
    """HSV jitter of (h, w, 3) uint8 RGB by the already drawn jitters (the
    generator stays in Python, so the draws are the plain version's)."""
    lib = get_lib()
    rgb_u8 = np.ascontiguousarray(rgb_u8, np.uint8)
    out = np.empty(rgb_u8.shape, np.uint8)
    lib.hsv_jitter_u8(_ptr(rgb_u8, ctypes.c_uint8),
                      rgb_u8.shape[0] * rgb_u8.shape[1], float(dh),
                      float(ds), float(dv), _ptr(out, ctypes.c_uint8))
    return out


def png_unfilter(data, height: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the PNG row filters of an inflated IDAT stream: `height` rows
    of a filter-type byte and `stride` bytes -> (height, stride) uint8.
    `bpp`: bytes per pixel, 1 for sub-byte depths."""
    lib = get_lib()
    raw = np.frombuffer(data, np.uint8)
    if raw.size != height * (stride + 1):
        raise ValueError(f"PNG image data holds {raw.size} bytes, expected "
                         f"{height} rows of 1 + {stride}")
    out = np.empty((height, stride), np.uint8)
    bad = lib.png_unfilter(_ptr(raw, ctypes.c_uint8), height, stride, bpp,
                           _ptr(out, ctypes.c_uint8))
    if bad:
        raise ValueError(f"unknown PNG filter type "
                         f"{raw[(bad - 1) * (stride + 1)]} in row {bad - 1}")
    return out


JPEG_ERRORS = {1: "truncated data", 2: "a bad or missing marker",
               3: "an unsupported coding", 4: "a bad Huffman code",
               5: "a bad table", 6: "no frame or scan", 7: "a bad scan header",
               8: "a frame unlike its header"}


def jpeg_decode(blob: bytes, width: int, height: int,
                channels: int) -> np.ndarray:
    """The pixels of a baseline JPEG file whose frame header gives
    `width`, `height` and `channels` (1 or 3): (h, w) or (h, w, 3)
    uint8, as PIL decodes them. Raises ValueError on a malformed
    stream."""
    lib = get_lib()
    raw = np.frombuffer(blob, np.uint8)
    out = np.empty((height, width, channels), np.uint8)
    err = lib.jpeg_decode(_ptr(raw, ctypes.c_uint8), raw.size, width,
                          height, channels, _ptr(out, ctypes.c_uint8))
    if err:
        raise ValueError(f"JPEG data: {JPEG_ERRORS.get(err, err)}")
    return out[..., 0] if channels == 1 else out
