"""The port's PNG codec (gdm_tpu_torch/data/imio.py) against cv2.imread,
which the JAX package's loader calls: decoded arrays are bit-equal for
8-bit RGB, RGBA, gray, palette and 16-bit gray files written by PIL and
by cv2, and for a file that uses every filter type; the writer's files
decode in cv2 to the array written; interlaced PNGs, JPEGs and missing
files raise."""

import struct
import zlib

import cv2
import numpy as np
import pytest
from PIL import Image

from gdm_tpu_torch.data import imio


def _smooth(rng, shape):
    """Image with local structure (random walks), so that PNG encoders
    pick a mix of row filters."""
    a = np.cumsum(rng.randint(0, 9, shape), axis=0) + np.cumsum(
        rng.randint(0, 5, shape), axis=1)
    return (a % 256).astype(np.uint8)


def _cv_rgb(path):
    return cv2.cvtColor(cv2.imread(path, cv2.IMREAD_COLOR),
                        cv2.COLOR_BGR2RGB)


@pytest.mark.parametrize("kind,writer", [
    (k, w) for k in ("rgb", "rgba", "gray", "palette", "gray16", "gray1")
    for w in ("pil", "cv2")
    if w == "pil" or k not in ("palette", "gray1")])   # cv2 writes neither
def test_decode_matches_cv2(tmp_path, kind, writer):
    rng = np.random.RandomState(len(kind))
    h, w = 37, 53
    if kind == "rgb":
        arr = _smooth(rng, (h, w, 3))
    elif kind == "rgba":
        arr = _smooth(rng, (h, w, 4))
    elif kind in ("gray", "palette"):
        arr = _smooth(rng, (h, w))
    elif kind == "gray16":
        arr = (rng.randint(0, 65536, (h, w))).astype(np.uint16)
    else:
        arr = rng.rand(h, w) > 0.5
    path = str(tmp_path / f"{kind}.png")
    if kind == "palette":
        Image.fromarray(_smooth(rng, (h, w, 3))).convert(
            "P", palette=Image.ADAPTIVE, colors=40).save(path)
    elif writer == "pil":
        Image.fromarray(arr).save(path)
    else:
        cv2.imwrite(path, arr[..., [2, 1, 0, 3][:arr.shape[2]]]
                    if arr.ndim == 3 else arr)
    np.testing.assert_array_equal(imio.imread_rgb(path), _cv_rgb(path))
    if kind in ("gray", "gray16", "gray1"):
        want = cv2.imread(path, cv2.IMREAD_UNCHANGED).astype(np.uint16)
        got = imio.imread_u16(path)
        assert got.dtype == np.uint16
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(
            imio.imread_mask(path), cv2.imread(path, cv2.IMREAD_GRAYSCALE))


def _filter_row(ftype, row, prev, bpp):
    """Reference PNG filter of one row (spec section 9), a plain loop."""
    out = bytearray(len(row))
    for i in range(len(row)):
        a = row[i - bpp] if i >= bpp else 0
        b = prev[i]
        c = prev[i - bpp] if i >= bpp else 0
        if ftype == 0:
            pred = 0
        elif ftype == 1:
            pred = a
        elif ftype == 2:
            pred = b
        elif ftype == 3:
            pred = (a + b) >> 1
        else:
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        out[i] = (row[i] - pred) & 0xFF
    return bytes(out)


def _write_png(path, arr, color_type, depth, ftypes, interlace=0):
    h, w = arr.shape[:2]
    rows = (arr.astype(">u2") if depth == 16 else arr).reshape(h, -1)
    raw = rows.view(np.uint8).reshape(h, -1)
    bpp = max(1, raw.shape[1] // w)
    prev = bytes(raw.shape[1])
    body = b""
    for y in range(h):
        ft = ftypes[y % len(ftypes)]
        row = raw[y].tobytes()
        body += bytes([ft]) + _filter_row(ft, row, prev, bpp)
        prev = row

    def chunk(t, d):
        return (struct.pack(">I", len(d)) + t + d
                + struct.pack(">I", zlib.crc32(t + d)))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth,
                                            color_type, 0, 0, interlace)))
        f.write(chunk(b"IDAT", zlib.compress(body)))
        f.write(chunk(b"IEND", b""))


@pytest.mark.parametrize("kind", ["rgb8", "rgba8", "gray16"])
def test_every_filter_type_in_one_image(tmp_path, kind):
    """Rows cycle through filter types 0-4 (the Average and Paeth rows go
    through the C++ row loop)."""
    rng = np.random.RandomState(7)
    path = str(tmp_path / "filters.png")
    if kind == "gray16":
        arr = rng.randint(0, 65536, (23, 31)).astype(np.uint16)
        _write_png(path, arr, 0, 16, [0, 1, 2, 3, 4])
        np.testing.assert_array_equal(imio.imread_u16(path), arr)
        np.testing.assert_array_equal(
            imio.imread_u16(path), cv2.imread(path, cv2.IMREAD_UNCHANGED))
        return
    c = 3 if kind == "rgb8" else 4
    arr = rng.randint(0, 256, (23, 31, c)).astype(np.uint8)
    _write_png(path, arr, 2 if c == 3 else 6, 8, [4, 3, 2, 1, 0])
    np.testing.assert_array_equal(imio.imread_rgb(path), arr[..., :3])
    np.testing.assert_array_equal(imio.imread_rgb(path), _cv_rgb(path))


@pytest.mark.parametrize("kind", ["rgb", "gray", "gray16", "rgba"])
def test_imwrite_round_trips_through_cv2(tmp_path, kind):
    rng = np.random.RandomState(3)
    arr = {"rgb": _smooth(rng, (29, 41, 3)), "gray": _smooth(rng, (29, 41)),
           "rgba": _smooth(rng, (29, 41, 4)),
           "gray16": rng.randint(0, 65536, (29, 41)).astype(np.uint16)}[kind]
    path = str(tmp_path / "w.png")
    imio.imwrite_png(path, arr)
    got = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    if arr.ndim == 3:
        got = got[..., [2, 1, 0, 3][:arr.shape[2]]]
    np.testing.assert_array_equal(got, arr)


def test_unsupported_inputs_raise(tmp_path):
    rng = np.random.RandomState(0)
    arr = rng.randint(0, 256, (8, 9, 3)).astype(np.uint8)
    inter = str(tmp_path / "interlaced.png")
    _write_png(inter, arr, 2, 8, [0], interlace=1)
    with pytest.raises(NotImplementedError, match="interlaced.png"):
        imio.imread_rgb(inter)
    jpg = str(tmp_path / "frame.jpg")
    cv2.imwrite(jpg, arr)
    with pytest.raises(NotImplementedError, match="frame.jpg"):
        imio.imread_rgb(jpg)
    with pytest.raises(FileNotFoundError):
        imio.imread_u16(str(tmp_path / "missing.png"))
    rgb = str(tmp_path / "rgb.png")
    imio.imwrite_png(rgb, arr)
    with pytest.raises(ValueError, match="single-channel"):
        imio.imread_u16(rgb)
    bad = bytearray(open(rgb, "rb").read())
    bad[40] ^= 0xFF                                 # inside IDAT
    with open(rgb, "wb") as f:
        f.write(bad)
    with pytest.raises(ValueError, match="CRC"):
        imio.imread_rgb(rgb)
