"""The port's JPEG decoder (`emsanet_tpu_torch/datasets/jpeg.py`,
`csrc/host/jpeg_baseline.h`) against PIL, on the CPU.

The decoder must return `np.asarray(PIL.Image.open(path))` bit for bit
(Pillow decodes with libjpeg-turbo: progressive scans, integer IDCT,
fancy upsampling), and `read_rgb` PIL's `.convert("RGB")`: on the
committed fixtures in `tests/data/jpeg/` (baseline, progressive, CMYK
and YCCK, each with the pixels PIL decoded, as a PNG file beside it
(CMYK's four channels as RGBA), which `chip_smoke.py` also holds the
decoder against on the card's machine, where there is no PIL), on
progressive 4:4:4, 4:2:2, 4:2:0 and gray files at odd sizes, optimized
and with restarts, on CMYK files and YCCK ones made by patching the
Adobe transform byte of a CMYK file, and on a hypothesis sweep of sizes,
subsamplings, qualities, restart intervals, optimized Huffman tables and
progressive coding. 12-bit files raise `NotPortedError` naming the file,
as PIL raises; arithmetic-coded, lossless and smoothed progressive
files: `tests/test_torch_port_jpeg_coding.py`. (The prepared-dataset
loader's `.jpg` files:
`tests/test_torch_port_datasets.py::test_jpeg_rgb_is_refused`.)

Write the fixtures anew with `PYTHONPATH=. python
tests/test_torch_port_jpeg.py`; with `--time` it prints the host ms per
640x480 decode (4:2:0 and 4:4:4, baseline and progressive, quality 75)
of the port's decoder and of PIL's, as JSON (the median of 30 decodes,
one thread).
"""

import io
import sys
from pathlib import Path

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st
from PIL import Image

from emsanet_tpu_torch.config import NotPortedError
from emsanet_tpu_torch.datasets import jpeg
from emsanet_tpu_torch.datasets.png import decode_image, read_png

ROOT = Path(__file__).resolve().parent.parent
DATA = ROOT / "tests" / "data" / "jpeg"
# name: (seed, height, width, mode, save keywords)
FIXTURES = {
    "q75_420_odd": (2, 37, 53, "RGB", dict(quality=75, subsampling=2)),
    "q90_444": (4, 24, 40, "RGB", dict(quality=90, subsampling=0)),
    "gray_odd": (0, 29, 31, "L", dict(quality=80)),
    "q85_422_restart": (3, 45, 67, "RGB", dict(
        quality=85, subsampling=1, restart_marker_blocks=2)),
    "q60_420_restart_rows": (1, 50, 81, "RGB", dict(
        quality=60, subsampling=2, restart_marker_rows=1, optimize=True)),
    "progressive_420_odd": (5, 43, 59, "RGB", dict(
        quality=80, subsampling=2, progressive=True, optimize=True,
        restart_marker_blocks=3)),
    "progressive_gray": (6, 26, 35, "L", dict(quality=85,
                                              progressive=True)),
    "cmyk_444": (7, 22, 30, "CMYK", dict(quality=90, subsampling=0)),
    "ycck_progressive_422": (8, 27, 33, "YCCK", dict(
        quality=85, subsampling=1, progressive=True)),
}
CHANNELS = {"L": 1, "RGB": 3, "CMYK": 4, "YCCK": 4}


def _content(h, w, channels, seed):
    """Gradients with noise: smooth areas and edges for the upsampling."""
    rng = np.random.RandomState(seed)
    y, x = np.mgrid[0:h, 0:w]
    planes = [(x * 5 + y * 3) % 256, (x * y // 3) % 256,
              255 - (x * 4 + y * 7) % 256, (x + 2 * y) % 256]
    img = np.stack(planes[:channels], -1) + rng.randint(-24, 25,
                                                         (h, w, channels))
    img = np.clip(img, 0, 255).astype(np.uint8)
    return img[..., 0] if channels == 1 else img


def encode(h, w, mode, seed, **kw) -> bytes:
    """A JPEG file as PIL writes it; YCCK: a CMYK file whose Adobe
    transform byte says YCCK (libjpeg then reads its channels as YCCK)."""
    buf = io.BytesIO()
    pil_mode = "CMYK" if mode == "YCCK" else mode
    Image.fromarray(_content(h, w, CHANNELS[mode], seed), pil_mode).save(
        buf, "JPEG", **kw)
    blob = bytearray(buf.getvalue())
    if mode == "YCCK":
        at = blob.index(b"Adobe") + 11
        assert blob[at] == 0
        blob[at] = 2
    return bytes(blob)


def _pil(blob: bytes, rgb: bool = False) -> np.ndarray:
    with Image.open(io.BytesIO(blob)) as img:
        return np.asarray(img.convert("RGB") if rgb else img)


def write_fixtures(out: Path = DATA) -> None:
    """Each fixture as PIL encodes it, and PIL's decode of it as PNG
    (four channels as RGBA)."""
    out.mkdir(parents=True, exist_ok=True)
    for name, (seed, h, w, mode, kw) in FIXTURES.items():
        blob = encode(h, w, mode, seed, **kw)
        (out / f"{name}.jpg").write_bytes(blob)
        Image.fromarray(_pil(blob)).save(out / f"{name}.png")


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_fixture_equals_pil_and_its_expected_pixels(name):
    path = str(DATA / f"{name}.jpg")
    got = jpeg.read_jpeg(path)
    with Image.open(path) as img:
        want = np.asarray(img)
        rgb = np.asarray(img.convert("RGB"))
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.array_equal(got, want)
    assert np.array_equal(got, read_png(str(DATA / f"{name}.png")))
    assert np.array_equal(decode_image(Path(path).read_bytes(), rgb=True),
                          rgb)


def _same_as_pil(blob):
    for rgb in (False, True):
        want = _pil(blob, rgb)
        got = decode_image(blob, rgb=rgb)
        assert got.dtype == want.dtype and got.shape == want.shape
        assert np.array_equal(got, want), f"rgb={rgb}"


@pytest.mark.parametrize("sampling", ["444", "422", "420", "gray"])
def test_progressive_equals_pil(sampling):
    mode = "L" if sampling == "gray" else "RGB"
    kw = {} if mode == "L" else {"subsampling": ("444", "422",
                                                 "420").index(sampling)}
    for i, (h, w) in enumerate(((1, 1), (1, 90), (90, 1), (17, 9),
                                (47, 89), (90, 90))):
        for extra in ({}, {"optimize": True}, {"restart_marker_blocks": 2},
                      {"restart_marker_rows": 1, "optimize": True}):
            _same_as_pil(encode(h, w, mode, i, quality=30 + 10 * i,
                                progressive=True, **kw, **extra))


@pytest.mark.parametrize("mode", ["CMYK", "YCCK", "CMYK_no_adobe"])
def test_four_components_equal_pil(mode):
    for i, (h, w) in enumerate(((1, 1), (19, 26), (45, 61))):
        for sub in (0, 1, 2):
            for progressive in (False, True):
                blob = encode(h, w, mode.split("_")[0], i, quality=85,
                              subsampling=sub, progressive=progressive,
                              restart_marker_blocks=i)
                if mode == "CMYK_no_adobe":  # drop the APP14 segment
                    at = blob.index(b"\xff\xee\x00\x0eAdobe")
                    blob = blob[:at] + blob[at + 16:]
                    assert b"Adobe" not in blob
                _same_as_pil(blob)


def test_fixtures_are_small():
    assert sum(p.stat().st_size for p in DATA.iterdir()) < 100_000


@settings(max_examples=80, deadline=None)
@given(h=st.integers(1, 90), w=st.integers(1, 90),
       gray=st.booleans(), subsampling=st.sampled_from([0, 1, 2]),
       quality=st.integers(1, 100), restart=st.integers(0, 4),
       optimize=st.booleans(), progressive=st.booleans(),
       seed=st.integers(0, 1000))
def test_sweep_equals_pil(h, w, gray, subsampling, quality, restart,
                          optimize, progressive, seed):
    kw = dict(quality=quality, optimize=optimize, progressive=progressive)
    if not gray:
        kw["subsampling"] = subsampling
    if restart:
        kw["restart_marker_blocks"] = restart
    buf = io.BytesIO()
    Image.fromarray(_content(h, w, 1 if gray else 3, seed)).save(
        buf, "JPEG", **kw)
    blob = buf.getvalue()
    with Image.open(io.BytesIO(blob)) as img:
        want = np.asarray(img)
    got = jpeg.decode_jpeg(blob)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.array_equal(got, want)


def _scans(blob: bytes):
    return [i for i in range(len(blob) - 1) if blob[i:i + 2] == b"\xff\xda"]


def test_progressive_and_cmyk_are_refused(tmp_path):
    """What was refused of them and is decoded now, equal to PIL: each
    prefix of a progressive file's scans (libjpeg-turbo smooths the
    blocks whose coefficient bits they leave unknown) and a CMYK file
    relabelled arithmetic-coded (SOF9: its Huffman stream read as
    arithmetic data). A 12-bit CMYK file stays refused, as PIL refuses
    it."""
    blob = encode(16, 24, "RGB", 0, progressive=True)
    for end in _scans(blob)[1:]:
        path = tmp_path / "progressive.jpg"
        path.write_bytes(blob[:end] + b"\xff\xd9")
        got = jpeg.read_jpeg(str(path))
        assert np.array_equal(got, _pil(path.read_bytes()))
    cmyk = encode(16, 24, "CMYK", 0)
    sof = cmyk.index(b"\xff\xc0")
    path = tmp_path / "cmyk.jpg"
    path.write_bytes(cmyk[:sof + 1] + b"\xc9" + cmyk[sof + 2:])
    assert np.array_equal(jpeg.read_jpeg(str(path)),
                          _pil(path.read_bytes()))
    path.write_bytes(cmyk[:sof + 4] + bytes([12]) + cmyk[sof + 5:])
    with pytest.raises(OSError):
        _pil(path.read_bytes())
    with pytest.raises(NotPortedError, match="12-bit.*cmyk.jpg"):
        jpeg.read_jpeg(str(path))
    with pytest.raises(ValueError, match="not a JPEG"):
        jpeg.decode_jpeg(b"\x89PNG", "x.png")


def time_decoders(runs: int = 30) -> dict:
    """{coding: {"port_ms", "pil_ms"}} per 640x480 decode."""
    import statistics
    import time

    out = {}
    for name, sub, progressive in (("4:2:0", 2, False), ("4:4:4", 0, False),
                                   ("4:2:0 progressive", 2, True),
                                   ("4:4:4 progressive", 0, True)):
        # quality 75: PIL's buffer for a progressive stream holds w * h
        # bytes, too few for this noisy image at quality 90
        blob = encode(480, 640, "RGB", 0, quality=75, subsampling=sub,
                      progressive=progressive)
        times = {}
        for who, fn in (("port_ms", lambda: jpeg.decode_jpeg(blob)),
                        ("pil_ms", lambda: np.asarray(
                            Image.open(io.BytesIO(blob))))):
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
    else:
        write_fixtures()
