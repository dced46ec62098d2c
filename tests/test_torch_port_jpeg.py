"""The port's baseline JPEG decoder (`emsanet_tpu_torch/datasets/jpeg.py`,
`csrc/host/jpeg_baseline.h`) against PIL, on the CPU.

The decoder must return `np.asarray(PIL.Image.open(path))` bit for bit
(Pillow decodes with libjpeg-turbo: integer IDCT, fancy upsampling):
on the committed fixtures in `tests/data/jpeg/` (each with the pixels
PIL decoded, as a PNG file beside it, which `chip_smoke.py` also holds
the decoder against on the card's machine, where there is no PIL), and
on a hypothesis sweep of sizes, subsamplings, qualities, restart
intervals and optimized Huffman tables. Progressive and CMYK files raise
`NotPortedError` naming the file. (The prepared-dataset loader's `.jpg`
files: `tests/test_torch_port_datasets.py::test_jpeg_rgb_is_refused`.)

Write the fixtures anew with `python tests/test_torch_port_jpeg.py`;
`python tests/test_torch_port_jpeg.py --time` prints the host ms per
640x480 decode (4:2:0 and 4:4:4, quality 90) of the port's decoder and
of PIL's, as JSON (the median of 30 decodes, one thread).
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
from emsanet_tpu_torch.datasets.png import read_png

ROOT = Path(__file__).resolve().parent.parent
DATA = ROOT / "tests" / "data" / "jpeg"
# name: (height, width, PIL mode, save keywords)
FIXTURES = {
    "q75_420_odd": (37, 53, "RGB", dict(quality=75, subsampling=2)),
    "q90_444": (24, 40, "RGB", dict(quality=90, subsampling=0)),
    "gray_odd": (29, 31, "L", dict(quality=80)),
    "q85_422_restart": (45, 67, "RGB", dict(quality=85, subsampling=1,
                                            restart_marker_blocks=2)),
    "q60_420_restart_rows": (50, 81, "RGB", dict(
        quality=60, subsampling=2, restart_marker_rows=1, optimize=True)),
}


def _content(h, w, channels, seed):
    """Gradients with noise: smooth areas and edges for the upsampling."""
    rng = np.random.RandomState(seed)
    y, x = np.mgrid[0:h, 0:w]
    planes = [(x * 5 + y * 3) % 256, (x * y // 3) % 256,
              255 - (x * 4 + y * 7) % 256]
    img = np.stack(planes[:channels], -1) + rng.randint(-24, 25,
                                                         (h, w, channels))
    img = np.clip(img, 0, 255).astype(np.uint8)
    return img[..., 0] if channels == 1 else img


def write_fixtures(out: Path = DATA) -> None:
    """Each fixture as PIL encodes it, and PIL's decode of it as PNG."""
    out.mkdir(parents=True, exist_ok=True)
    for i, (name, (h, w, mode, kw)) in enumerate(sorted(FIXTURES.items())):
        img = Image.fromarray(_content(h, w, 1 if mode == "L" else 3, i))
        img.save(out / f"{name}.jpg", "JPEG", **kw)
        with Image.open(out / f"{name}.jpg") as decoded:
            decoded.save(out / f"{name}.png")


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_fixture_equals_pil_and_its_expected_pixels(name):
    path = str(DATA / f"{name}.jpg")
    got = jpeg.read_jpeg(path)
    with Image.open(path) as img:
        want = np.asarray(img)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.array_equal(got, want)
    assert np.array_equal(got, read_png(str(DATA / f"{name}.png")))


def test_fixtures_are_small():
    assert sum(p.stat().st_size for p in DATA.iterdir()) < 100_000


@settings(max_examples=80, deadline=None)
@given(h=st.integers(1, 90), w=st.integers(1, 90),
       gray=st.booleans(), subsampling=st.sampled_from([0, 1, 2]),
       quality=st.integers(1, 100), restart=st.integers(0, 4),
       optimize=st.booleans(), seed=st.integers(0, 1000))
def test_sweep_equals_pil(h, w, gray, subsampling, quality, restart,
                          optimize, seed):
    kw = dict(quality=quality, optimize=optimize)
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


def test_progressive_and_cmyk_are_refused(tmp_path):
    rgb = _content(16, 24, 3, 0)
    progressive = str(tmp_path / "progressive.jpg")
    Image.fromarray(rgb).save(progressive, progressive=True)
    with pytest.raises(NotPortedError,
                       match="progressive JPEG.*progressive.jpg"):
        jpeg.read_jpeg(progressive)
    cmyk = str(tmp_path / "cmyk.jpg")
    Image.fromarray(rgb).convert("CMYK").save(cmyk)
    with pytest.raises(NotPortedError, match="CMYK JPEG.*cmyk.jpg"):
        jpeg.read_jpeg(cmyk)
    with pytest.raises(ValueError, match="not a JPEG"):
        jpeg.decode_jpeg(b"\x89PNG", "x.png")


def time_decoders(runs: int = 30) -> dict:
    """{subsampling: {"port_ms", "pil_ms"}} per 640x480 decode."""
    import statistics
    import time

    out = {}
    for name, sub in (("4:2:0", 2), ("4:4:4", 0)):
        buf = io.BytesIO()
        Image.fromarray(_content(480, 640, 3, 0)).save(
            buf, "JPEG", quality=90, subsampling=sub)
        blob = buf.getvalue()
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
