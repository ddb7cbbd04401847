"""The zlib PNG reader behind KITTI image loading (data/kitti.py)."""

import glob
import os
import struct
import zlib

import numpy as np
import pytest

from vloam.data.kitti import load_image_gray, read_png

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures", "kitti_mini",
                        "sequences", "00", "image_0")


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else (b if pb <= pc else c)


def _encode_png(img: np.ndarray, kind: int) -> bytes:
    """Reference encoder: every scanline filtered with `kind` (0-4)."""
    h, w, ch = img.shape
    color = {1: 0, 2: 4, 3: 2, 4: 6}[ch]
    rows = img.reshape(h, w * ch).astype(int)
    out = bytearray()
    for y in range(h):
        line = rows[y]
        up = rows[y - 1] if y else np.zeros_like(line)
        filt = []
        for x in range(w * ch):
            a = line[x - ch] if x >= ch else 0
            b = up[x]
            c = up[x - ch] if x >= ch else 0
            pred = [0, a, b, (a + b) // 2, _paeth(a, b, c)][kind]
            filt.append((line[x] - pred) & 255)
        out += bytes([kind] + filt)

    def chunk(tag, body):
        return (struct.pack(">I", len(body)) + tag + body
                + struct.pack(">I", zlib.crc32(tag + body)))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(bytes(out))) + chunk(b"IEND", b""))


@pytest.mark.parametrize("kind", [0, 1, 2, 3, 4])
@pytest.mark.parametrize("channels", [1, 3])
def test_read_png_every_filter(tmp_path, kind, channels):
    rng = np.random.default_rng(kind * 10 + channels)
    img = rng.integers(0, 256, (7, 9, channels), dtype=np.uint8)
    path = tmp_path / "x.png"
    path.write_bytes(_encode_png(img, kind))
    np.testing.assert_array_equal(read_png(path), img)


def test_load_image_gray_matches_opencv_on_kitti_fixture():
    cv2 = pytest.importorskip("cv2")
    files = sorted(glob.glob(os.path.join(FIXTURES, "*.png")))
    assert files
    for f in files:
        want = cv2.imread(f, cv2.IMREAD_GRAYSCALE)
        got = load_image_gray(f)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(np.round(got * 255).astype(np.uint8),
                                      want)


def test_read_png_rejects_unsupported(tmp_path):
    path = tmp_path / "x.png"
    body = struct.pack(">IIBBBBB", 2, 2, 16, 0, 0, 0, 0)  # 16-bit grey
    path.write_bytes(b"\x89PNG\r\n\x1a\n" + struct.pack(">I", len(body))
                     + b"IHDR" + body + b"\0\0\0\0")
    with pytest.raises(ValueError, match="unsupported"):
        read_png(path)
    path.write_bytes(b"GIF89a")
    with pytest.raises(ValueError, match="not a PNG"):
        read_png(path)
