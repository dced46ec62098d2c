"""The port's JPEG decoder on the codings PIL decodes and cannot write,
against PIL, on the CPU: arithmetic-coded files (sequential SOF9 and
progressive SOF10; 1, 3 and 4 components; sampling factors, restarts
and DAC conditioning), 8-bit lossless files (SOF3: predictors 1-7, point
transforms, restarts, interleaved or not, subsampled components; gray,
RGB and CMYK), and
progressive files whose scans leave coefficient bits unknown, whose
blocks libjpeg-turbo smooths (every prefix of a file's scans). Each
decode equals `np.asarray(PIL.Image.open(...))` bit for bit, and
`decode_image(..., rgb=True)` equals `.convert("RGB")`. Files PIL
refuses (12-bit, hierarchical, arithmetic lossless, lossless in YCbCr)
raise here too, and the test shows PIL raising.

The files come from the small encoders of `tests/torch_jpeg_encoders.py`
and from Pillow; the committed ones (`tests/data/jpeg/arith_*`,
`lossless_*`, `smoothed_*`, each with PIL's pixels as PNG beside it,
which `chip_smoke.py` holds the decoder against on the card's machine)
are written anew by `python tests/test_torch_port_jpeg_coding.py`;
`--time` prints the host ms per 640x480 decode of an arithmetic
(sequential, progressive) and a lossless file against Huffman, port and
PIL, as JSON; `--simd` prints, for each case of the Huffman files
relabelled SOF10, how many of its 12 files PIL's default decode (with
libjpeg-turbo's SIMD code) gives other pixels for than the port.
"""

import io
import sys
from pathlib import Path

import numpy as np
import pytest
import torch_jpeg_encoders as enc
from PIL import Image
from test_torch_port_jpeg import DATA, _content, encode

from emsanet_tpu_torch.config import NotPortedError
from emsanet_tpu_torch.datasets import jpeg
from emsanet_tpu_torch.datasets.png import decode_image, read_png

S420, S422 = [(2, 2), (1, 1), (1, 1)], [(2, 1), (1, 1), (1, 1)]
_img = _content  # (h, w, channels, seed) -> gradients with noise


def _smoothed(n_scans, h, w, mode, seed, **kw):
    return enc.truncated_scans(encode(h, w, mode, seed, progressive=True,
                                      **kw), n_scans)


# name: a function that writes the file's bytes
CODED = {
    "arith_seq_gray": lambda: enc.encode_arith(_img(29, 31, 1, 0)),
    "arith_seq_420_restart_dac": lambda: enc.encode_arith(
        _img(37, 53, 3, 2), sampling=S420, restart=3,
        dac={(0, 0): 0x52, (0, 1): 0x31, (1, 0): 2, (1, 1): 12}),
    "arith_seq_cmyk": lambda: enc.encode_arith(_img(22, 30, 4, 7)),
    "arith_prog_422_restart": lambda: enc.encode_arith(
        _img(27, 45, 3, 3), progressive=True, sampling=S422, restart=2),
    "arith_prog_gray": lambda: enc.encode_arith(_img(26, 35, 1, 6),
                                                progressive=True),
    "arith_prog_cmyk_restart": lambda: enc.encode_arith(
        _img(19, 26, 4, 8), progressive=True, restart=5),
    "lossless_rgb_p1": lambda: enc.encode_lossless(_img(17, 23, 3, 1), 1),
    "lossless_rgb_p2_restart": lambda: enc.encode_lossless(
        _img(17, 23, 3, 2), 2, restart_rows=4),
    "lossless_rgb_p3_pt1": lambda: enc.encode_lossless(_img(17, 23, 3, 3), 3,
                                                       pt=1),
    "lossless_gray_p4_pt2_restart": lambda: enc.encode_lossless(
        _img(21, 19, 1, 4), 4, pt=2, restart_rows=3),
    "lossless_cmyk_p5": lambda: enc.encode_lossless(_img(13, 17, 4, 5), 5),
    "lossless_rgb_p6_scans": lambda: enc.encode_lossless(
        _img(17, 23, 3, 6), 6, interleaved=False),
    "lossless_rgb_p7_pt3": lambda: enc.encode_lossless(_img(17, 23, 3, 7), 7,
                                                       pt=3, restart_rows=5),
    "lossless_420_p5_restart": lambda: enc.encode_lossless(
        _img(17, 23, 3, 8), 5, sampling=S420, restart_rows=2),
    # DC scan only: the DC and the first 9 AC coefficients interpolated
    "smoothed_420_dc_only": lambda: _smoothed(1, 43, 59, "RGB", 5,
                                              quality=80, subsampling=2),
    "smoothed_444_three_scans": lambda: _smoothed(3, 24, 40, "RGB", 4,
                                                  quality=90, subsampling=0),
    "smoothed_gray_four_scans": lambda: _smoothed(4, 26, 35, "L", 6,
                                                  quality=85),
}


def _pil(blob: bytes, rgb: bool = False) -> np.ndarray:
    with Image.open(io.BytesIO(blob)) as img:
        return np.asarray(img.convert("RGB") if rgb else img)


def write_fixtures(out: Path = DATA) -> None:
    for name, make in CODED.items():
        blob = make()
        (out / f"{name}.jpg").write_bytes(blob)
        Image.fromarray(_pil(blob)).save(out / f"{name}.png")


def _same_as_pil(blob):
    for rgb in (False, True):
        want = _pil(blob, rgb)
        got = decode_image(blob, rgb=rgb)
        assert got.dtype == want.dtype and got.shape == want.shape
        assert np.array_equal(got, want), f"rgb={rgb}"


@pytest.mark.parametrize("name", sorted(CODED))
def test_coded_fixture_equals_pil_and_its_expected_pixels(name):
    path = DATA / f"{name}.jpg"
    got = jpeg.read_jpeg(str(path))
    want = read_png(str(DATA / f"{name}.png"))
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.array_equal(got, want)
    _same_as_pil(path.read_bytes())


@pytest.mark.parametrize("progressive", [False, True],
                         ids=["sequential", "progressive"])
def test_arithmetic_equals_pil(progressive):
    rng = np.random.default_rng(int(progressive))
    cases = [(1, 1, 1, None), (1, 40, 3, S420), (40, 1, 3, S422),
             (17, 9, 4, None), (33, 47, 3, [(1, 2), (1, 1), (1, 1)]),
             (24, 18, 1, [(2, 2)])]
    for i, (h, w, c, sampling) in enumerate(cases):
        restart = int(rng.integers(0, 4))
        dac = ({(0, 0): int(rng.integers(0, 16)) * 0x11,
                (1, 0): int(rng.integers(1, 64))} if i % 2 else None)
        _same_as_pil(enc.encode_arith(
            _img(h, w, c, i), progressive=progressive, sampling=sampling,
            restart=restart, dac=dac, quality=int(rng.integers(20, 95))))


@pytest.mark.parametrize("predictor", range(1, 8))
def test_lossless_equals_pil(predictor):
    """Each predictor over sizes, point transforms, restarts, one scan or
    one a component; and subsampled components (MCUs of h x v samples,
    upsampled by replication)."""
    for i, (h, w, c) in enumerate(((1, 1, 3), (1, 29, 1), (29, 1, 3),
                                   (11, 14, 4), (16, 21, 3))):
        for pt, restart_rows, interleaved in ((0, 0, True), (i % 3, 1, False),
                                              (2, 3, True)):
            _same_as_pil(enc.encode_lossless(
                _img(h, w, c, predictor + i), predictor, pt=pt,
                restart_rows=restart_rows if restart_rows < h else 0,
                interleaved=interleaved))
    for i, sampling in enumerate((S420, S422, [(1, 2), (1, 1), (1, 1)],
                                  [(2, 2), (1, 2), (2, 1)])):
        for restart_rows, interleaved in ((0, True), (2, True), (0, False)):
            _same_as_pil(enc.encode_lossless(
                _img(13 + i, 19 + 2 * i, 3, predictor), predictor, pt=i % 2,
                sampling=sampling, restart_rows=restart_rows,
                interleaved=interleaved))


@pytest.mark.parametrize("mode,sub,extra", [
    ("RGB", 2, {}), ("RGB", 0, {"optimize": True}),
    ("RGB", 1, {"restart_marker_blocks": 2}), ("L", 0, {}),
    ("CMYK", 2, {}), ("YCCK", 0, {})], ids=["420", "444_optimized",
                                            "422_restart", "gray", "cmyk",
                                            "ycck"])
def test_every_scan_prefix_equals_pil(mode, sub, extra):
    """Each prefix of a progressive file's scans: the blocks libjpeg-turbo
    smooths (DC only: the DC interpolated too; later, the first 9 AC
    coefficients where their bits are not all known), and whole files."""
    kw = {} if mode == "L" else {"subsampling": sub}
    for i, (h, w) in enumerate(((9, 9), (37, 61), (64, 48))):
        blob = encode(h, w, mode, i, progressive=True, quality=60 + 10 * i,
                      **kw, **extra)
        for n in range(1, len(enc.scan_starts(blob)) + 1):
            _same_as_pil(enc.truncated_scans(blob, n)
                         if n < len(enc.scan_starts(blob)) else blob)


def test_large_arithmetic_file_equals_pil_with_a_whole_file_buffer():
    """PIL reads a JPEG file into its decoder 64 KiB at a time, and
    libjpeg-turbo's arithmetic decoder cannot suspend for more input
    (jdarith.c: JERR_CANT_SUSPEND), so PIL raises on an arithmetic-coded
    file whose coded data outgrows that buffer. Given the whole file at
    once, PIL decodes it, and the port equals it (a 640x480 progressive
    4:2:0 file of 137 KB)."""
    blob = enc.encode_arith(_img(480, 640, 3, 0), sampling=S420,
                            progressive=True)
    assert len(blob) > 1 << 16
    with pytest.raises(OSError):
        _pil(blob)
    with Image.open(io.BytesIO(blob)) as img:
        img.decodermaxblock = len(blob)
        want = np.asarray(img)
    assert np.array_equal(jpeg.decode_jpeg(blob), want)


def _raises_as_pil(blob, error, match):
    with pytest.raises(Exception):
        _pil(blob)
    with pytest.raises(error, match=match):
        jpeg.decode_jpeg(blob, "x.jpg")


def test_what_pil_refuses_is_refused():
    """12-bit and hierarchical frames, arithmetic-coded lossless ones and
    lossless files in YCbCr (libjpeg-turbo converts no lossless colour):
    PIL raises on each, and so does the port."""
    base = encode(16, 24, "RGB", 0)
    sof = base.index(b"\xff\xc0")
    _raises_as_pil(base[:sof + 4] + bytes([12]) + base[sof + 5:],
                   NotPortedError, "12-bit.*x.jpg")
    for marker, name in ((0xC5, "differential sequential"),
                         (0xC6, "differential progressive"),
                         (0xC7, "differential lossless"),
                         (0xCD, "arithmetic-coded differential sequential"),
                         (0xCE, "arithmetic-coded differential progressive"),
                         (0xCF, "arithmetic-coded differential lossless")):
        _raises_as_pil(base[:sof + 1] + bytes([marker]) + base[sof + 2:],
                       NotPortedError, f"{name} JPEG.*x.jpg")
    lossless = enc.encode_lossless(_img(8, 8, 3, 0), 1)
    at = lossless.index(b"\xff\xc3")
    _raises_as_pil(lossless[:at + 1] + b"\xcb" + lossless[at + 2:],
                   NotPortedError, "arithmetic-coded lossless.*x.jpg")
    _raises_as_pil(enc.encode_lossless(_img(8, 8, 3, 0), 1, jfif=True),
                   ValueError, "x.jpg: a lossless file in YCbCr")


# (h, w), seed of the progressive Huffman files that
# `test_huffman_stream_read_as_arithmetic_equals_pil_without_simd` relabels
RELABELLED = [(hw, seed) for hw in ((16, 24), (9, 9), (37, 61), (64, 48))
              for seed in range(3)]

RELABELLED_CASES = {"444": ("RGB", 0), "422": ("RGB", 1), "420": ("RGB", 2),
                    "gray": ("L", 0)}


def _relabelled(mode, sub):
    """The case's progressive Huffman files, each relabelled SOF10."""
    kw = {} if mode == "L" else {"subsampling": sub}
    blobs = []
    for (h, w), seed in RELABELLED:
        blob = encode(h, w, mode, seed, progressive=True, **kw)
        sof = blob.index(b"\xff\xc2")
        blobs.append(blob[:sof + 1] + b"\xca" + blob[sof + 2:])
    return blobs


PIL_WITHOUT_SIMD = """
import sys
from pathlib import Path
import numpy as np
from PIL import Image
for path in sorted(Path(sys.argv[1]).glob("*.jpg")):
    with Image.open(path) as img:
        np.save(path.with_suffix(".npy"), np.asarray(img))
        np.save(path.with_suffix(".rgb.npy"), np.asarray(img.convert("RGB")))
"""


@pytest.mark.parametrize("case", sorted(RELABELLED_CASES))
def test_huffman_stream_read_as_arithmetic_equals_pil_without_simd(
        tmp_path, case):
    """Progressive Huffman files relabelled progressive arithmetic (SOF2
    -> SOF10): the Huffman stream is read as arithmetic-coded data, a
    garbage stream whose coefficients leave the range any encoder
    writes. libjpeg-turbo decodes such blocks one way in its portable C
    code and another in its SIMD code: on an AVX2 host 9 of these 48
    files (3 of the 4:4:4 ones, 2 / 1 of the 4:2:2 / 4:2:0 ones, 3 gray
    ones; `--simd`) give other pixels with SIMD than without, and a gray
    file's only SIMD step is the IDCT. The port follows the C code. So
    PIL with libjpeg-turbo's SIMD switched off (`JSIMD_FORCENONE=1`, read
    when the library first runs, hence a process of its own) equals the
    port on every file: where the port and PIL's default decode differ,
    PIL's two paths differ too."""
    import os
    import subprocess

    blobs = _relabelled(*RELABELLED_CASES[case])
    for i, blob in enumerate(blobs):
        (tmp_path / f"{i:02d}.jpg").write_bytes(blob)
    subprocess.run([sys.executable, "-c", PIL_WITHOUT_SIMD, str(tmp_path)],
                   env={**os.environ, "JSIMD_FORCENONE": "1"}, check=True,
                   timeout=120)
    for i, blob in enumerate(blobs):
        for rgb, suffix in ((False, ".npy"), (True, ".rgb.npy")):
            want = np.load(tmp_path / f"{i:02d}{suffix}")
            got = decode_image(blob, rgb=rgb)
            assert got.dtype == want.dtype and got.shape == want.shape
            assert np.array_equal(got, want), (RELABELLED[i], rgb)


def _pil_whole(blob: bytes) -> np.ndarray:
    """PIL's decode with the whole file in its read buffer (see
    `test_large_arithmetic_file_equals_pil_with_a_whole_file_buffer`)."""
    with Image.open(io.BytesIO(blob)) as img:
        img.decodermaxblock = len(blob)
        return np.asarray(img)


def simd_differences() -> dict:
    """{case: how many of its 12 relabelled files PIL's default decode,
    libjpeg-turbo's SIMD code included, gives other pixels for than the
    port} (`test_huffman_stream_read_as_arithmetic_equals_pil_without_simd`
    holds the port to PIL with SIMD off)."""
    return {case: sum(not np.array_equal(decode_image(blob), _pil(blob))
                      for blob in _relabelled(*spec))
            for case, spec in sorted(RELABELLED_CASES.items())}


def time_decoders(runs: int = 10) -> dict:
    """{coding: {"port_ms", "pil_ms"}} per 640x480 RGB decode (the
    median of `runs`; PIL given the whole file at once)."""
    import statistics
    import time

    img = _img(480, 640, 3, 0)
    blobs = {"huffman 4:2:0": encode(480, 640, "RGB", 0, quality=75,
                                     subsampling=2),
             "arithmetic 4:2:0": enc.encode_arith(img, sampling=S420),
             "arithmetic progressive 4:2:0": enc.encode_arith(
                 img, sampling=S420, progressive=True),
             "lossless predictor 1": enc.encode_lossless(img, 1)}
    out = {}
    for name, blob in blobs.items():
        times = {}
        for who, fn in (("port_ms", lambda: jpeg.decode_jpeg(blob)),
                        ("pil_ms", lambda: _pil_whole(blob))):
            fn()
            samples = []
            for _ in range(runs):
                t0 = time.perf_counter()
                fn()
                samples.append((time.perf_counter() - t0) * 1e3)
            times[who] = statistics.median(samples)
        out[name] = times
    return out


if __name__ == "__main__":
    if sys.argv[1:] == ["--time"]:
        import json

        print(json.dumps(time_decoders()))
    elif sys.argv[1:] == ["--simd"]:
        import json

        print(json.dumps(simd_differences()))
    else:
        write_fixtures()
