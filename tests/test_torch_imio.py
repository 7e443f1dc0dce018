"""The port's PNG codec (gdm_tpu_torch/data/imio.py) against cv2.imread,
which the JAX package's loader calls: decoded arrays are bit-equal for
8-bit RGB, RGBA, gray, palette and 16-bit gray files written by PIL and
by cv2, and for a file that uses every filter type; the writer's files
decode in cv2 to the array written; interlaced PNGs, progressive JPEGs
and missing files raise.  JPEG: baseline files decode bit-equal to
cv2.imread at qualities 50/75/95 in 4:2:0, 4:2:2, 4:4:4 and gray, at an
odd size and with restart markers, written by cv2, PIL and the port's
own encoder."""

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
    cv2.imwrite(jpg, arr, [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
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


def _textured(rng, h, w):
    """A frame with gradients, noise and a flat block: every kind of
    8x8 block a photo has."""
    yy, xx = np.mgrid[:h, :w]
    img = np.stack([(xx * 0.4) % 256, (yy * 0.5) % 256,
                    ((xx + yy) * 0.3) % 256], -1)
    img = (img + rng.randn(h, w, 3) * 20).clip(0, 255).astype(np.uint8)
    img[h // 5:h // 2, w // 6:w // 2] = [250, 10, 30]
    return img


_SAMPLING = {"420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
             "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
             "444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444}


@pytest.mark.parametrize("quality", [50, 75, 95])
@pytest.mark.parametrize("layout", ["420", "422", "444", "gray"])
@pytest.mark.parametrize("restart", [0, 7])
def test_jpeg_decode_matches_cv2(tmp_path, quality, layout, restart):
    rng = np.random.RandomState(quality + restart)
    img = _textured(rng, 481, 641)                  # odd size, both axes
    path = str(tmp_path / f"q{quality}_{layout}_{restart}.jpg")
    params = [cv2.IMWRITE_JPEG_QUALITY, quality,
              cv2.IMWRITE_JPEG_RST_INTERVAL, restart]
    if layout == "gray":
        cv2.imwrite(path, img[..., 1], params)
    else:
        cv2.imwrite(path, img[..., ::-1], params + [
            cv2.IMWRITE_JPEG_SAMPLING_FACTOR, _SAMPLING[layout]])
    np.testing.assert_array_equal(imio.imread_rgb(path), _cv_rgb(path))


@pytest.mark.parametrize("quality", [75, 95])
def test_jpeg_decode_of_pil_files_matches_cv2(tmp_path, quality):
    img = _textured(np.random.RandomState(1), 120, 160)
    path = str(tmp_path / "pil.jpg")
    Image.fromarray(img).save(path, quality=quality)
    np.testing.assert_array_equal(imio.imread_rgb(path), _cv_rgb(path))


@pytest.mark.parametrize("subsample,restart", [(True, 0), (False, 0),
                                               (True, 5)])
def test_port_jpeg_encoder_files(tmp_path, subsample, restart):
    """The port's own baseline files: cv2 decodes them, to the port's
    decode bit for bit, and close to the image written."""
    img = _textured(np.random.RandomState(2), 97, 131)
    path = str(tmp_path / "own.jpg")
    imio.imwrite_jpeg(path, img, quality=95, subsample=subsample,
                      restart_interval=restart)
    got = imio.imread_rgb(path)
    np.testing.assert_array_equal(got, _cv_rgb(path))
    err = np.abs(got.astype(int) - img).mean()
    assert err < (12.0 if subsample else 4.0), err
    gray = str(tmp_path / "own_gray.jpg")
    imio.imwrite_jpeg(gray, img[..., 0], quality=90)
    np.testing.assert_array_equal(imio.imread_rgb(gray), _cv_rgb(gray))


def test_jpeg_huffman_tables_are_the_standard_ones(tmp_path):
    """The encoder's DHT and DQT segments equal libjpeg's (cv2's) at the
    same quality: the Annex K tables and libjpeg's quality scaling."""
    img = _textured(np.random.RandomState(3), 32, 48)
    own, ref = str(tmp_path / "own.jpg"), str(tmp_path / "cv.jpg")
    imio.imwrite_jpeg(own, img, quality=80)
    cv2.imwrite(ref, img[..., ::-1], [cv2.IMWRITE_JPEG_QUALITY, 80])

    def segments(path, marker):
        data = open(path, "rb").read()
        out, pos = [], 2
        while pos < len(data) and data[pos] == 0xFF:
            m = data[pos + 1]
            n = struct.unpack(">H", data[pos + 2:pos + 4])[0]
            if m == marker:
                out.append(data[pos + 4:pos + 2 + n])
            if m == 0xDA:
                break
            pos += 2 + n
        return b"".join(out)

    for marker in (0xC4, 0xDB):
        a, b = segments(own, marker), segments(ref, marker)
        assert a and a == b, hex(marker)
