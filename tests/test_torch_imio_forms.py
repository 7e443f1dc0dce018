"""The port's readers against the JAX package's (cv2.imread) on every file
form ``gdm_tpu.data.imio`` reads: for each of imread_rgb, imread_mask
and imread_u16 the port's array equals gdm_tpu's (shape, dtype, every
value) over

  * EXIF orientations 1-8 in JPEG (II and MM TIFF blocks) and PNG
    ``eXIf``, and OpenCV's rules for which block and entry count (named
    cases and a seeded sweep of malformed blocks);
  * 1/2/4/8/16-bit gray, gray+alpha, RGB, RGBA and palette PNGs, with
    and without tRNS, non-interlaced and Adam7 (sizes under 8 px too),
    written here and by PIL; with gAMA, sRGB and sBIT chunks (libpng
    reads colour as gray through gamma tables);
  * colour and gray JPEGs read as masks and unchanged, 4:2:0, 4:2:2,
    4:4:4, 4:1:1, 4:4:0 and gray, baseline and progressive;
  * progressive JPEGs from cv2 and PIL at qualities 50/75/95, restart
    intervals 0 and 7 and odd sizes, each also against its baseline twin;
  * the colour-space rules of libjpeg (JFIF over Adobe, 'RGB' component
    ids) and chroma at most two samples wide.

Progressive files whose scans leave low coefficients unrefined raise
NotImplementedError, and out-of-sequence or truncated ones ValueError
(cv2 decodes those with warnings).  The committed fixtures of
tests/data/imio/ decode to their manifest, which is checked against
cv2 here so that it cannot go stale."""

import hashlib
import io
import json
import os
import os.path as osp
import struct
import zlib

import cv2
import numpy as np
import pytest
from PIL import Image

from gdm_tpu.data import imio as ref
from gdm_tpu_torch.data import exif, imio

READERS = ("imread_rgb", "imread_mask", "imread_u16")
FIXTURES = osp.join(osp.dirname(osp.abspath(__file__)), "data", "imio")
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
         (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
SAMPLING = {k: getattr(cv2, f"IMWRITE_JPEG_SAMPLING_FACTOR_{k}")
            for k in ("420", "422", "444", "411", "440")}


def assert_same_as_jax(path, readers=READERS):
    for name in readers:
        want = getattr(ref, name)(path)
        got = getattr(imio, name)(path)
        assert (got.shape, got.dtype) == (want.shape, want.dtype), \
            (name, got.shape, got.dtype, want.shape, want.dtype)
        np.testing.assert_array_equal(got, want, err_msg=name)


def textured(rng, h, w):
    yy, xx = np.mgrid[:h, :w]
    img = np.stack([(xx * 0.9) % 256, (yy * 1.1) % 256,
                    ((xx + yy) * 0.7) % 256], -1)
    img = (img + rng.randn(h, w, 3) * 15).clip(0, 255).astype(np.uint8)
    img[h // 5:h // 2, w // 6:w // 2] = [250, 10, 30]
    return img


# ------------------------------------------------------------------ PNG


def chunk(ctype, body):
    return (struct.pack(">I", len(body)) + ctype + body
            + struct.pack(">I", zlib.crc32(ctype + body)))


def pack_rows(a, depth):
    """[h, w, c] samples -> packed scanline bytes [h, stride]."""
    h = a.shape[0]
    if depth == 16:
        return a.astype(">u2").reshape(h, -1).view(np.uint8)
    flat = a.reshape(h, -1).astype(np.uint8)
    if depth == 8:
        return flat
    per = 8 // depth
    flat = np.pad(flat, ((0, 0), (0, (-flat.shape[1]) % per)))
    shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
    return (flat.reshape(h, -1, per) << shifts).sum(-1).astype(np.uint8)


def sub_filter(rows, bpp):
    """Sub-filtered scanlines (type 1), so that unfiltering is exercised
    per pass."""
    pred = np.zeros_like(rows)
    pred[:, bpp:] = rows[:, :-bpp]
    return np.concatenate([np.ones((rows.shape[0], 1), np.uint8),
                           rows - pred], axis=1)


def write_png(path, a, color_type, depth, interlace=0, plte=None, trns=None,
              before=b"", after=b""):
    """A PNG of samples ``a`` [h, w(, c)], Adam7 with ``interlace``;
    ``before`` / ``after`` are extra chunks around the image data."""
    h, w = a.shape[:2]
    a = a.reshape(h, w, -1)
    bpp = max(1, a.shape[2] * depth // 8)
    body = b""
    for x0, y0, dx, dy in (ADAM7 if interlace else ((0, 0, 1, 1),)):
        sub = a[y0::dy, x0::dx]
        if sub.size:
            body += sub_filter(pack_rows(sub, depth), bpp).tobytes()
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(
            ">IIBBBBB", w, h, depth, color_type, 0, 0, interlace)))
        if plte is not None:
            f.write(chunk(b"PLTE", plte.astype(np.uint8).tobytes()))
        if trns is not None:
            f.write(chunk(b"tRNS", trns))
        f.write(before + chunk(b"IDAT", zlib.compress(body)) + after
                + chunk(b"IEND", b""))


PNG_FORMS = [(ct, d, t) for ct, depths in (
    (0, (1, 2, 4, 8, 16)), (2, (8, 16)), (3, (1, 2, 4, 8)), (4, (8, 16)),
    (6, (8, 16))) for d in depths for t in (False, True)
    if not (t and ct in (4, 6))]


def png_form(rng, path, color_type, depth, trns, interlace, h, w, **kw):
    top = (1 << depth) - 1
    a = rng.randint(0, top + 1, (h, w, CHANNELS[color_type]))
    plte = tr = None
    if color_type == 3:
        n = min(top + 1, 200)
        a = rng.randint(0, n, (h, w, 1))
        plte = rng.randint(0, 256, (n, 3))
        tr = bytes(rng.randint(0, 256, min(n, 30)).astype(np.uint8)) \
            if trns else None
    elif trns:
        key = a[0, 0] if color_type == 2 else a[0, 0, :1]
        tr = b"".join(struct.pack(">H", int(v)) for v in key)
    write_png(path, a, color_type, depth, interlace, plte, tr, **kw)
    return a


@pytest.mark.parametrize("size", [(1, 1), (3, 5), (7, 6), (37, 53)])
@pytest.mark.parametrize("interlace", [0, 1])
@pytest.mark.parametrize("form", PNG_FORMS,
                         ids=[f"ct{c}-{d}bit{'-trns' if t else ''}"
                              for c, d, t in PNG_FORMS])
def test_png_forms(tmp_path, form, interlace, size):
    """Every colour type and bit depth, tRNS, Adam7 at sizes that leave
    passes empty: all three readers equal gdm_tpu's."""
    color_type, depth, trns = form
    rng = np.random.RandomState(color_type * 100 + depth + 7 * interlace
                                + size[1])
    path = str(tmp_path / "f.png")
    png_form(rng, path, color_type, depth, trns, interlace, *size)
    assert_same_as_jax(path)


@pytest.mark.parametrize("mode", ["RGB", "RGBA", "P", "P4", "LA", "I;16",
                                  "L"])
def test_pil_png_as_mask_and_u16(tmp_path, mode):
    rng = np.random.RandomState(len(mode))
    img = Image.fromarray(textured(rng, 29, 41))
    path = str(tmp_path / "pil.png")
    if mode in ("P", "P4"):
        colors = 12 if mode == "P4" else 60
        img.convert("P", palette=Image.ADAPTIVE, colors=colors).save(
            path, bits=4 if mode == "P4" else 8)
    elif mode == "I;16":
        Image.fromarray(rng.randint(0, 65536, (29, 41)).astype(
            np.uint16)).save(path)
    else:
        img.convert(mode).save(path)
    assert_same_as_jax(path)


def _gama(v):
    return chunk(b"gAMA", struct.pack(">I", v))


# (chunks before the image data, after it): libpng's gamma rules
GAMMA_CASES = {
    **{f"gAMA {v}": ([_gama(v)], []) for v in (
        45455, 30000, 94000, 95000, 96000, 105000, 105001, 220000, 15,
        2 ** 31 - 1)},
    "sRGB": ([chunk(b"sRGB", b"\0")], []),
    "sRGB after gAMA 1.0": ([_gama(100000), chunk(b"sRGB", b"\0")], []),
    "gAMA 1.0 after sRGB": ([chunk(b"sRGB", b"\0"), _gama(100000)], []),
    "gAMA 0 then 45455": ([_gama(0), _gama(45455)], []),
    "gAMA 1.0 then 45455": ([_gama(100000), _gama(45455)], []),
    "gAMA after the image data": ([], [_gama(45455)]),
    **{f"gAMA 45455, sBIT {b}": ([_gama(45455), chunk(b"sBIT", bytes(b))],
                                 []) for b in ((4, 4, 4), (8, 9, 10),
                                               (12, 11, 3), (16, 16, 16))},
}


@pytest.mark.parametrize("form", [(2, 8), (6, 8), (2, 16), (6, 16), (3, 8),
                                  (3, 4), (0, 16), (4, 8)],
                         ids=lambda f: f"ct{f[0]}-{f[1]}bit")
@pytest.mark.parametrize("case", sorted(GAMMA_CASES))
def test_png_gamma(tmp_path, case, form):
    """A colour file with a file gamma libpng takes (gAMA, sRGB) reads
    gray through its gamma tables (R = G = B pixels too); gray files and
    the other flags are untouched."""
    color_type, depth = form
    before, after = GAMMA_CASES[case]
    if color_type in (2, 6) and case.startswith("gAMA 45455, sBIT"):
        before = [before[0], chunk(b"sBIT", before[1][8:-4][:3] + (
            b"\x08" if color_type == 6 else b""))]
    elif "sBIT" in case:
        before = before[:1]
    rng = np.random.RandomState(len(case) + depth)
    path = str(tmp_path / "g.png")
    png_form(rng, path, color_type, depth, False, 0, 13, 21,
             before=b"".join(before), after=b"".join(after))
    assert_same_as_jax(path)


@pytest.mark.parametrize("order", ["PLTE gAMA", "gAMA PLTE", "PLTE sRGB",
                                   "sRGB PLTE"])
def test_png_gamma_before_plte_only(tmp_path, order):
    """libpng takes gAMA and sRGB only ahead of PLTE: an RGB file with a
    suggested palette and a gamma chunk after it reads gray without
    gamma."""
    rng = np.random.RandomState(len(order))
    palette = chunk(b"PLTE", bytes(rng.randint(0, 256, 48).astype(np.uint8)))
    gamma = _gama(45455) if "gAMA" in order else chunk(b"sRGB", b"\0")
    path = str(tmp_path / "p.png")
    write_png(path, rng.randint(0, 256, (13, 21, 3)), 2, 8,
              before=palette + gamma if order.startswith("PLTE")
              else gamma + palette)
    assert_same_as_jax(path)


def test_png_gamma_gray_pixels(tmp_path):
    """Pixels with R = G = B take the file-to-screen table (16 bits: its
    rounding to 8 bits), not the weighted sum."""
    for depth, vals in ((16, [0, 127, 128, 129, 255, 256, 383, 1000, 32768,
                              40000, 65279, 65280, 65407, 65408, 65535]),
                        (8, [0, 1, 7, 128, 254, 255])):
        a = np.repeat(np.array(vals)[None, :, None], 3, axis=2)
        for g in (45455, 2 ** 31 - 1):
            path = str(tmp_path / f"gray{depth}_{g}.png")
            write_png(path, a, 2, depth, before=_gama(g))
            assert_same_as_jax(path)


def test_adam7_decodes_to_the_samples_written(tmp_path):
    """The interlaced writer here and the port's reader agree with the
    array itself (not only with cv2) at 16-bit RGBA."""
    rng = np.random.RandomState(5)
    a = rng.randint(0, 65536, (11, 13, 4)).astype(np.uint16)
    path = str(tmp_path / "a.png")
    write_png(path, a, 6, 16, interlace=1)
    np.testing.assert_array_equal(imio.imread(path, "unchanged"),
                                  a[..., [2, 1, 0, 3]])


# ----------------------------------------------------------------- EXIF


def tiff(entries, order=b"II", n=None, magic=42):
    e = "<" if order == b"II" else ">"
    b = order + struct.pack(e + "HI", magic, 8)
    b += struct.pack(e + "H", len(entries) if n is None else n)
    for tag, typ, cnt, val in entries:
        if isinstance(val, bytes):
            b += struct.pack(e + "HHI", tag, typ, cnt) + val
        else:
            b += struct.pack(e + "HHIHH", tag, typ, cnt, val, 0)
    return b + struct.pack(e + "I", 0)


def orient(o, order=b"II"):
    return tiff([(0x0112, 3, 1, o)], order)


def app1(body, header=b"Exif\0\0"):
    body = header + body
    return b"\xff\xe1" + struct.pack(">H", len(body) + 2) + body


def jpeg_bytes(img, **kw):
    params = [cv2.IMWRITE_JPEG_QUALITY, kw.get("quality", 90),
              cv2.IMWRITE_JPEG_PROGRESSIVE, kw.get("progressive", 0)]
    if img.ndim == 3:
        params += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                   SAMPLING[kw.get("sampling", "420")]]
        img = img[..., ::-1]
    ok, enc = cv2.imencode(".jpg", img, params)
    assert ok
    return enc.tobytes()


def with_segments(data, segs):
    return data[:2] + b"".join(segs) + data[2:]


@pytest.mark.parametrize("order", [b"II", b"MM"])
@pytest.mark.parametrize("o", range(1, 9))
@pytest.mark.parametrize("progressive", [0, 1])
def test_exif_orientation_jpeg(tmp_path, o, order, progressive):
    img = textured(np.random.RandomState(o), 21, 34)
    path = str(tmp_path / "o.jpg")
    with open(path, "wb") as f:
        f.write(with_segments(jpeg_bytes(img, progressive=progressive),
                              [app1(orient(o, order))]))
    assert_same_as_jax(path)
    assert imio.imread_rgb(path).shape[:2] == ((34, 21) if o >= 5
                                               else (21, 34))


@pytest.mark.parametrize("where", ["before", "after"])
@pytest.mark.parametrize("o", range(1, 9))
def test_exif_orientation_png(tmp_path, o, where):
    rng = np.random.RandomState(o)
    path = str(tmp_path / "o.png")
    png_form(rng, path, 2, 8, False, o % 2, 13, 22,
             **{where: chunk(b"eXIf", orient(o, b"MM" if o % 2 else b"II"))})
    assert_same_as_jax(path)


# (name, APP1 segments): each a rule of OpenCV's EXIF reading
JPEG_EXIF_CASES = {
    "orientation 0": [app1(orient(0))],
    "orientation 9": [app1(orient(9))],
    "orientation 65535": [app1(orient(65535))],
    "LONG entry": [app1(tiff([(0x0112, 4, 1, 6)]))],
    "first entry of the tag wins": [app1(tiff([(0x0112, 3, 1, 6),
                                              (0x0112, 3, 1, 3)]))],
    "first block wins": [app1(orient(6)), app1(orient(3))],
    "an orientation 0 block first": [app1(orient(0)), app1(orient(6))],
    "XMP APP1 first": [app1(b"<x/>", b"http://ns.adobe.com/xap/1.0/\0"),
                       app1(orient(6))],
    "no Exif header": [app1(orient(6), b"Abcd\0\0")],
    "Exif header without the two zeros": [app1(orient(6), b"Exif")],
    "APP2": [b"\xff\xe2" + app1(orient(6))[2:]],
    "magic 43": [app1(tiff([(0x0112, 3, 1, 6)], magic=43))],
    "IM read big-endian": [app1(b"IM" + orient(6, b"MM")[2:])],
    "XX read big-endian": [app1(b"XX" + orient(6, b"MM")[2:])],
    "entry count past the end": [app1(tiff([(0x0112, 3, 1, 6)], n=5))],
    "string out of range first": [app1(tiff([
        (0x010F, 2, 1000, struct.pack("<I", 5000)), (0x0112, 3, 1, 6)]))],
    "string out of range after": [app1(tiff([
        (0x0112, 3, 1, 6), (0x010F, 2, 1000, struct.pack("<I", 5000))]))],
    "rational out of range first": [app1(tiff([
        (0x011A, 5, 1, struct.pack("<I", 5000)), (0x0112, 3, 1, 6)]))],
    "unparsed tag out of range first": [app1(tiff([
        (0x8825, 4, 1, struct.pack("<I", 5000)), (0x0112, 3, 1, 6)]))],
    "a block that ends early, then one": [
        app1(tiff([(0x010F, 2, 1000, struct.pack("<I", 5000)),
                   (0x0112, 3, 1, 3)])), app1(orient(6))],
    "value cut at its last byte": [app1(orient(6)[:-7])],
    "value cut after it": [app1(orient(6)[:-6])],
}


@pytest.mark.parametrize("case", sorted(JPEG_EXIF_CASES))
def test_jpeg_exif_rules(tmp_path, case):
    img = textured(np.random.RandomState(1), 6, 8)
    path = str(tmp_path / "r.jpg")
    with open(path, "wb") as f:
        f.write(with_segments(jpeg_bytes(img, sampling="444"),
                              JPEG_EXIF_CASES[case]))
    assert_same_as_jax(path)


def test_exif_after_the_first_scan_is_not_read(tmp_path):
    """libjpeg saves markers up to the first SOS for OpenCV: an Exif APP1
    between progressive scans or after a baseline scan changes nothing."""
    img = textured(np.random.RandomState(2), 6, 8)
    for progressive in (0, 1):
        data = jpeg_bytes(img, sampling="444", progressive=progressive)
        at = data.find(b"\xff\xda", data.find(b"\xff\xda") + 2) \
            if progressive else data.rfind(b"\xff\xd9")
        path = str(tmp_path / f"late{progressive}.jpg")
        with open(path, "wb") as f:
            f.write(data[:at] + app1(orient(6)) + data[at:])
        assert imio.imread_rgb(path).shape == (6, 8, 3)
        assert_same_as_jax(path)


PNG_EXIF_CASES = {
    "two chunks: the first wins": ([orient(6), orient(3)], []),
    "before and after: the first wins": ([orient(3)], [orient(6)]),
    "a first chunk without orientation": (
        [tiff([(0x010E, 2, 2, b"ab\0\0")]), orient(6)], []),
    "Exif header (libpng refuses it)": ([b"Exif\0\0" + orient(6)], []),
    "bad byte order, then a good chunk": ([b"XX" + orient(6)[2:],
                                           orient(6)], []),
    "bad magic, then a good chunk": ([b"II+\0" + orient(3)[4:], orient(6)],
                                     []),
    "3 bytes, then a good chunk": ([b"II*", orient(6)], []),
    "4 bytes, then a good chunk": ([b"II*\0", orient(6)], []),
    "string out of range first": ([tiff([
        (0x010F, 2, 1000, struct.pack("<I", 5000)), (0x0112, 3, 1, 6)])],
        []),
}


@pytest.mark.parametrize("case", sorted(PNG_EXIF_CASES))
def test_png_exif_rules(tmp_path, case):
    before, after = PNG_EXIF_CASES[case]
    path = str(tmp_path / "r.png")
    png_form(np.random.RandomState(3), path, 2, 8, False, 0, 6, 8,
             before=b"".join(chunk(b"eXIf", b) for b in before),
             after=b"".join(chunk(b"eXIf", b) for b in after))
    assert_same_as_jax(path)


def random_block(rng):
    tags = (0x010E, 0x010F, 0x0110, 0x0112, 0x011A, 0x011B, 0x0128, 0x0131,
            0x0132, 0x013E, 0x013F, 0x0211, 0x0213, 0x0214, 0x8298, 0x8769,
            0x0100, 0x9999)
    entries = [(int(rng.choice(tags)), int(rng.choice([2, 3, 4, 5])),
                int(rng.choice([1, 2, 4, 8, 40])),
                int(rng.choice([0, 1, 3, 6, 8, 9, 20, 30, 60, 5000])))
               for _ in range(rng.randint(0, 5))]
    b = tiff(entries, [b"II", b"MM"][rng.randint(2)])
    if rng.rand() < 0.2:
        b = b[:rng.randint(0, len(b))]
    if rng.rand() < 0.15:
        b = bytes([b"IMXA"[rng.randint(4)]]) + b[1:]
    if rng.rand() < 0.2:
        b += bytes(rng.randint(0, 256, 40).astype(np.uint8))
    return b


@pytest.mark.parametrize("seed", range(4))
def test_exif_sweep_matches_cv2(seed):
    """Seeded malformed and well-formed EXIF blocks, up to three per file:
    the orientation the port applies is the one cv2 applies (read from
    the decoded frame's shape and pixels)."""
    rng = np.random.RandomState(seed)
    img = textured(rng, 6, 8)
    base = cv2.imdecode(np.frombuffer(jpeg_bytes(img, sampling="444"),
                                      np.uint8), cv2.IMREAD_COLOR)
    ok, enc = cv2.imencode(".png", base)
    png = enc.tobytes()
    for _ in range(60):
        blocks = [random_block(rng) for _ in range(rng.randint(1, 4))]
        data = with_segments(jpeg_bytes(img, sampling="444"),
                             [app1(b) for b in blocks])
        want = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
        got = exif.apply_orientation(base, exif.orientation(
            exif.jpeg_exif_blocks(data)))
        np.testing.assert_array_equal(got, want, err_msg=repr(blocks))
        data = png[:33] + b"".join(chunk(b"eXIf", b) for b in blocks) \
            + png[33:]
        want = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
        got = exif.apply_orientation(base, exif.orientation(
            exif.png_exif_block(imio._chunks("sweep", data))))
        np.testing.assert_array_equal(got, want, err_msg=repr(blocks))


# ----------------------------------------------------------------- JPEG


@pytest.mark.parametrize("progressive", [0, 1])
@pytest.mark.parametrize("layout", ["420", "422", "444", "411", "440",
                                    "gray"])
def test_jpeg_as_mask_and_u16(tmp_path, layout, progressive):
    img = textured(np.random.RandomState(len(layout)), 45, 67)
    path = str(tmp_path / "c.jpg")
    with open(path, "wb") as f:
        f.write(jpeg_bytes(img[..., 1] if layout == "gray" else img,
                           sampling="420" if layout == "gray" else layout,
                           progressive=progressive))
    assert_same_as_jax(path)


def progressive_file(path, writer, img, layout, quality, restart):
    if writer == "cv2":
        params = [cv2.IMWRITE_JPEG_QUALITY, quality,
                  cv2.IMWRITE_JPEG_RST_INTERVAL, restart,
                  cv2.IMWRITE_JPEG_PROGRESSIVE, 1]
        if layout == "gray":
            cv2.imwrite(path, img[..., 1], params)
        else:
            cv2.imwrite(path, img[..., ::-1], params + [
                cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[layout]])
        return
    kw = {"quality": quality, "progressive": True}
    if restart:
        kw["restart_marker_blocks"] = restart
    if layout == "gray":
        Image.fromarray(img[..., 1]).save(path, **kw)
    else:
        Image.fromarray(img).save(path, subsampling={"444": 0, "422": 1,
                                                     "420": 2}[layout], **kw)


@pytest.mark.parametrize("restart", [0, 7])
@pytest.mark.parametrize("quality", [50, 75, 95])
@pytest.mark.parametrize("layout", ["420", "422", "444", "gray"])
@pytest.mark.parametrize("writer", ["cv2", "pil"])
def test_progressive_jpeg(tmp_path, writer, layout, quality, restart):
    """Progressive files decode bit-equal to cv2 in every reader, and a
    cv2 progressive file to the pixels of its baseline twin."""
    rng = np.random.RandomState(quality + restart)
    img = textured(rng, 121, 163)
    path = str(tmp_path / "p.jpg")
    progressive_file(path, writer, img, layout, quality, restart)
    assert open(path, "rb").read().find(b"\xff\xc2") > 0
    assert_same_as_jax(path)
    if writer == "cv2":
        twin = str(tmp_path / "b.jpg")
        params = [cv2.IMWRITE_JPEG_QUALITY, quality,
                  cv2.IMWRITE_JPEG_RST_INTERVAL, restart]
        if layout == "gray":
            cv2.imwrite(twin, img[..., 1], params)
        else:
            cv2.imwrite(twin, img[..., ::-1], params + [
                cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[layout]])
        np.testing.assert_array_equal(imio.imread_rgb(path),
                                      imio.imread_rgb(twin))


@pytest.mark.parametrize("size", [(1, 1), (2, 3), (9, 7), (17, 33),
                                  (481, 641)])
@pytest.mark.parametrize("layout", ["420", "422", "444"])
def test_progressive_odd_sizes(tmp_path, layout, size):
    img = textured(np.random.RandomState(size[0]), *size)
    path = str(tmp_path / "p.jpg")
    progressive_file(path, "cv2", img, layout, 75, 3)
    assert_same_as_jax(path)


@pytest.mark.parametrize("width", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("layout", ["420", "422"])
def test_narrow_chroma_is_box_upsampled(tmp_path, layout, width):
    """libjpeg-turbo upsamples chroma at most two samples wide by
    repetition, not by the fancy triangle filter."""
    img = np.random.RandomState(width).randint(0, 256, (17, width, 3))
    path = str(tmp_path / "n.jpg")
    with open(path, "wb") as f:
        f.write(jpeg_bytes(img.astype(np.uint8), sampling=layout))
    assert_same_as_jax(path)


def _colour_space_file(form, progressive):
    img = np.random.RandomState(9).randint(0, 256, (37, 53, 3)).astype(
        np.uint8)
    data = jpeg_bytes(img, sampling="444", progressive=progressive)
    assert data[2:4] == b"\xff\xe0"                    # cv2 writes JFIF
    if form != "jfif and adobe 0":
        data = data[:2] + data[4 + struct.unpack(">H", data[4:6])[0]:]
    if form.startswith(("jfif", "adobe")):
        seg = b"Adobe" + struct.pack(">HHHB", 100, 0, 0, int(form[-1]))
        data = data[:2] + b"\xff\xee" + struct.pack(">H", len(seg) + 2) \
            + seg + data[2:]
    if form == "ids RGB":
        out, pos = bytearray(data), 0
        sof = data.find(b"\xff\xc2" if progressive else b"\xff\xc0")
        for k in range(3):
            out[sof + 10 + 3 * k] = b"RGB"[k]
        while (pos := data.find(b"\xff\xda", pos + 1)) > 0:
            for k in range(data[pos + 4]):
                out[pos + 5 + 2 * k] = b"RGB"[data[pos + 5 + 2 * k] - 1]
        data = bytes(out)
    return data


@pytest.mark.parametrize("progressive", [0, 1])
@pytest.mark.parametrize("form", ["jfif and adobe 0", "adobe 0", "adobe 1",
                                  "ids RGB", "no marker"])
def test_jpeg_colour_space_rules(tmp_path, form, progressive):
    """JFIF means YCbCr whatever an Adobe marker says; without JFIF the
    Adobe transform, and without either component ids 'R' 'G' 'B', mean
    RGB samples (and an RGB->gray conversion for IMREAD_GRAYSCALE)."""
    path = str(tmp_path / "cs.jpg")
    with open(path, "wb") as f:
        f.write(_colour_space_file(form, progressive))
    assert_same_as_jax(path)


def _scans(data):
    """(start, end) of each SOS segment with its entropy-coded data."""
    out, pos = [], 2
    while data[pos + 1] != 0xD9:
        n = struct.unpack(">H", data[pos + 2:pos + 4])[0]
        end = pos + 2 + n
        if data[pos + 1] == 0xDA:
            while not (data[end] == 0xFF and data[end + 1] != 0
                       and not 0xD0 <= data[end + 1] <= 0xD7):
                end += 1
            out.append((pos, end))
        pos = end
    return out


def test_progressive_refusals(tmp_path):
    """Scans that stop short of the last refinement of a low coefficient
    (libjpeg-turbo block-smooths the result) raise NotImplementedError;
    a scan sequence libjpeg warns of, and a truncated file, ValueError
    (cv2 decodes all three with warnings)."""
    img = textured(np.random.RandomState(4), 61, 83)
    data = jpeg_bytes(img, progressive=1)
    scans = _scans(data)
    assert len(scans) == 10                      # libjpeg's default script

    def write(name, body):
        path = str(tmp_path / name)
        with open(path, "wb") as f:
            f.write(body)
        return path

    def drop(i):
        return data[:scans[i][0]] + data[scans[i][1]:]

    for i in (7, 8, 9):                          # the AC refinements to Al 0
        with pytest.raises(NotImplementedError, match=f"drop{i}.jpg"):
            imio.imread_rgb(write(f"drop{i}.jpg", drop(i)))
    for i in (0, 1, 3, 5):
        with pytest.raises(ValueError, match="out of sequence"):
            imio.imread_rgb(write(f"drop{i}.jpg", drop(i)))
    # the DC refinement alone may go: DC keeps its first scan's precision
    path = write("drop6.jpg", drop(6))
    assert_same_as_jax(path)
    for cut in (len(data) // 3, len(data) - 2):
        with pytest.raises(ValueError, match="trunc.jpg"):
            imio.imread_rgb(write("trunc.jpg", data[:cut]))
        assert cv2.imread(str(tmp_path / "trunc.jpg")) is not None


# ------------------------------------------------------------- fixtures


def _sha(arr):
    return hashlib.sha256(np.ascontiguousarray(arr).tobytes()).hexdigest()


MANIFEST = json.load(open(osp.join(FIXTURES, "manifest.json")))


def test_fixture_directory_is_the_manifest():
    names = sorted(n for n in os.listdir(FIXTURES) if n != "manifest.json")
    assert names == sorted(MANIFEST["files"])
    assert len(names) <= 12
    assert sum(osp.getsize(osp.join(FIXTURES, n)) for n in names) < 400_000


@pytest.mark.parametrize("name", sorted(MANIFEST["files"]))
def test_fixture_manifest_matches_cv2_and_the_port(name):
    path = osp.join(FIXTURES, name)
    flags = {"color": cv2.IMREAD_COLOR, "gray": cv2.IMREAD_GRAYSCALE,
             "unchanged": cv2.IMREAD_UNCHANGED}
    for mode, want in MANIFEST["files"][name].items():
        arr = cv2.imread(path, flags[mode])
        if mode == "color":
            arr = arr[..., ::-1]
        assert [list(arr.shape), str(arr.dtype), _sha(arr)] == [
            want["shape"], want["dtype"], want["sha256"]], (name, mode)
        got = imio.imread(path, mode)
        assert [list(got.shape), str(got.dtype), _sha(got)] == [
            want["shape"], want["dtype"], want["sha256"]], (name, mode)
    assert_same_as_jax(path)


def test_fixture_script_writes_the_committed_files(tmp_path):
    """scripts/make_imio_fixtures.py, run again, writes the same bytes
    and manifest (the files are deterministic for this cv2 and PIL)."""
    import subprocess
    import sys

    root = osp.dirname(osp.dirname(osp.abspath(__file__)))
    subprocess.run([sys.executable, osp.join(root, "scripts",
                                             "make_imio_fixtures.py"),
                    "--out", str(tmp_path)], check=True, capture_output=True,
                   timeout=120)
    for name in [*MANIFEST["files"], "manifest.json"]:
        assert open(tmp_path / name, "rb").read() == open(
            osp.join(FIXTURES, name), "rb").read(), name


def test_jpeg_reader_on_an_in_memory_pil_file(tmp_path):
    """A PIL progressive JPEG with an EXIF block PIL writes itself."""
    img = textured(np.random.RandomState(6), 31, 45)
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "JPEG", quality=80, progressive=True,
                              exif=b"Exif\0\0" + orient(8, b"MM"))
    path = str(tmp_path / "pil.jpg")
    with open(path, "wb") as f:
        f.write(buf.getvalue())
    assert imio.imread_mask(path).shape == (45, 31)
    assert_same_as_jax(path)
