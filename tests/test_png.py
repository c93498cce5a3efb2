"""The zlib+numpy PNG codec and the cv2-free synthetic renderer."""

import os
import struct
import sys
import zlib

import numpy as np
import pytest

from privacy_preserving_sfm_tpu.features import extraction
from privacy_preserving_sfm_tpu.utils import png

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _encode(img, ftype):
    """Reference PNG encoder applying one filter type to every row (the
    forward filters of the PNG specification, written independently of
    the decoder)."""
    ch = 1 if img.ndim == 2 else img.shape[2]
    color = {1: 0, 2: 4, 3: 2, 4: 6}[ch]
    h, w = img.shape[:2]
    rows = img.reshape(h, w * ch).astype(np.int64)
    raw = bytearray()
    prior = np.zeros(w * ch, np.int64)
    for y in range(h):
        x = rows[y]
        left = np.concatenate([np.zeros(ch, np.int64), x[:-ch]])
        upleft = np.concatenate([np.zeros(ch, np.int64), prior[:-ch]])
        pred = [np.zeros_like(x), left, prior, (left + prior) // 2,
                _paeth(left, prior, upleft)][ftype]
        raw.append(ftype)
        raw += ((x - pred) % 256).astype(np.uint8).tobytes()
        prior = x

    def chunk(t, b):
        return struct.pack(">I", len(b)) + t + b + struct.pack(
            ">I", zlib.crc32(t + b) & 0xFFFFFFFF)

    return (png.SIGNATURE
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0,
                                         0))
            + chunk(b"IDAT", zlib.compress(bytes(raw)))
            + chunk(b"IEND", b""))


def _image(shape, seed=0):
    rng = np.random.default_rng(seed)
    smooth = np.cumsum(rng.integers(0, 9, shape), axis=0) % 256
    return smooth.astype(np.uint8)


@pytest.mark.parametrize("ftype", [0, 1, 2, 3, 4])
@pytest.mark.parametrize("shape", [(13, 17), (13, 17, 3), (13, 17, 4),
                                   (13, 17, 2)])
def test_decode_every_filter_type(tmp_path, ftype, shape):
    img = _image(shape, seed=ftype)
    path = tmp_path / "f.png"
    path.write_bytes(_encode(img, ftype))
    np.testing.assert_array_equal(png.read_png(str(path)), img)


@pytest.mark.parametrize("shape", [(31, 45), (31, 45, 3), (31, 45, 4)])
def test_write_read_round_trip(tmp_path, shape):
    img = _image(shape, seed=1)
    path = str(tmp_path / "r.png")
    png.write_png(path, img)
    assert png.is_png(path)
    np.testing.assert_array_equal(png.read_png(path), img)


@pytest.mark.parametrize("mode,shape", [("L", (29, 33)),
                                        ("RGB", (29, 33, 3)),
                                        ("RGBA", (29, 33, 4))])
def test_agrees_with_pil(tmp_path, mode, shape):
    Image = pytest.importorskip("PIL.Image")
    img = _image(shape, seed=2)
    path = str(tmp_path / "p.png")
    Image.fromarray(img, mode).save(path, optimize=True)
    np.testing.assert_array_equal(png.read_png(path), img)
    with Image.open(path) as im:
        gray = np.asarray(im.convert("L"))
    np.testing.assert_array_equal(
        extraction.load_image_grayscale_u8(path), gray)
    png.write_png(str(tmp_path / "q.png"), img)
    with Image.open(str(tmp_path / "q.png")) as im:
        np.testing.assert_array_equal(np.asarray(im), img)


def test_unsupported_png_raises(tmp_path):
    body = struct.pack(">IIBBBBB", 4, 4, 16, 0, 0, 0, 0)  # 16-bit gray
    path = tmp_path / "d.png"
    path.write_bytes(png.SIGNATURE + struct.pack(">I", len(body))
                     + b"IHDR" + body + b"\0\0\0\0")
    with pytest.raises(png.PNGError, match="bit depth 16"):
        png.read_png(str(path))


def test_renderer_is_deterministic_from_its_seed(tmp_path):
    sys.path.insert(0, ROOT)
    from tools.synth_dataset import make_dataset

    def render(name, seed):
        out = str(tmp_path / name)
        make_dataset(out, 2, width=160, height=120, seed=seed, scene="box")
        files = sorted(os.listdir(out))
        return {f: open(os.path.join(out, f), "rb").read() for f in files}

    a, b, c = render("a", 3), render("b", 3), render("c", 4)
    assert a == b
    assert a["img000.png"] != c["img000.png"]
    img = png.read_png(str(tmp_path / "a" / "img000.png"))
    assert img.shape == (120, 160) and img.dtype == np.uint8
    assert 0.005 < np.mean(img == 96) < 0.9  # facets and background
