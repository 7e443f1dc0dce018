"""Image decode and encode on the host: PNG in numpy and zlib, JPEG in C++.

Counterpart of gdm_tpu/data/imio.py, which decodes with cv2; the GPU
host has neither cv2 nor PIL.  The readers return what cv2.imread
returns for the same file, with cv2's read flag:

  * ``imread_rgb`` is ``IMREAD_COLOR`` + BGR->RGB: alpha and tRNS
    dropped, palette and gray expanded to RGB, 16-bit samples keep their
    high byte, 1/2/4-bit gray scales to 0..255;
  * ``imread_mask`` is ``IMREAD_GRAYSCALE``: colour, palette and 16-bit
    colour PNGs through libpng's rgb_to_gray (weights 9797/19234/3737 of
    32768, truncating at 8 bits, rounding at 16 bits before the high
    byte; through libpng's gamma tables where a gAMA or sRGB chunk gives
    a file gamma), alpha stripped; a JPEG's luma plane (libjpeg's
    JCS_GRAYSCALE output, not a conversion of the colour decode);
  * ``imread_u16`` is ``IMREAD_UNCHANGED`` + ``astype(uint16)``: gray as
    one channel, gray+alpha as BGRA, colour and palette as BGR, or BGRA
    where the file has alpha or a tRNS chunk; a colour JPEG as BGR;
  * ``imread(path, mode)`` is any of the three ("color", "gray",
    "unchanged") with the file's own sample type.

``IMREAD_COLOR`` and ``IMREAD_GRAYSCALE`` apply the EXIF orientation (a
JPEG's ``Exif`` APP1 or a PNG's ``eXIf`` chunk) as OpenCV does, and
``IMREAD_UNCHANGED`` does not (``data/exif.py``).  The tests hold every
reader bit-equal to cv2 on 1/2/4/8/16-bit gray, gray+alpha, RGB, RGBA
and palette PNGs, with and without tRNS, gAMA, sRGB or sBIT,
interlaced (Adam7) or not.

PNG unfiltering: None, Sub (a wrapping cumsum over each byte lane) and
Up run on whole rows in numpy; Average and Paeth are sequential per byte
and run in a small C++ row loop (``csrc/png_unfilter.cpp``).  Adam7
files are seven such passes, each filtered on its own, scattered into
the image.

JPEG goes through ``csrc/jpeg.cpp``: baseline and progressive 8-bit
Huffman files, 4:2:0, 4:2:2, 4:4:4, 4:1:1, 4:4:0 or gray, restart
markers included, decoded as libjpeg-turbo's defaults decode them (ISLOW
IDCT, its upsamplers, fixed-point YCbCr tables, JFIF / Adobe colour
rules), so each reader equals cv2.imread on them.  Arithmetic-coded,
lossless, hierarchical, 12-bit and 4-component JPEGs raise
NotImplementedError naming the file, as does a progressive file whose
scans leave low coefficients unrefined (which libjpeg-turbo
block-smooths); a truncated or corrupt file, or a progressive one whose
scans are out of sequence (where libjpeg-turbo warns and decodes on),
raises ValueError.  ``imwrite_jpeg`` writes baseline files (standard
tables).  A missing file raises FileNotFoundError, as the cv2 readers
do.
"""

from __future__ import annotations

import ctypes
import math
import struct
import zlib

import numpy as np

from gdm_tpu_torch.data import exif

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}   # by PNG colour type


def _chunks(path: str, data: bytes):
    pos = len(_SIGNATURE)
    while pos + 8 <= len(data):
        length, ctype = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        crc = data[pos + 8 + length:pos + 12 + length]
        if len(body) != length or len(crc) != 4:
            raise ValueError(f"{path}: truncated PNG chunk {ctype!r}")
        if zlib.crc32(ctype + body) != struct.unpack(">I", crc)[0]:
            raise ValueError(f"{path}: CRC error in PNG chunk {ctype!r}")
        yield ctype, body
        if ctype == b"IEND":
            return
        pos += 12 + length
    raise ValueError(f"{path}: PNG without IEND")


def _unfilter_lib():
    from gdm_tpu_torch import _build

    lib = _build.load("png_unfilter")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.gdm_png_unfilter_row.argtypes = [i, p, p, p, i, i]
    lib.gdm_png_unfilter_row.restype = i
    return lib


def unfilter(path: str, raw: np.ndarray, bpp: int) -> np.ndarray:
    """Filtered scanlines [H, 1 + stride] uint8 -> bytes [H, stride]."""
    h, stride = raw.shape[0], raw.shape[1] - 1
    out = np.empty((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    lib = None
    for y in range(h):
        ftype, cur, row = int(raw[y, 0]), raw[y, 1:], out[y]
        if ftype == 0:
            row[:] = cur
        elif ftype == 1:
            np.cumsum(cur.reshape(-1, bpp), axis=0, dtype=np.uint8,
                      out=row.reshape(-1, bpp))
        elif ftype == 2:
            np.add(cur, prev, out=row)
        elif ftype in (3, 4):
            if lib is None:
                lib = _unfilter_lib()
            cur = np.ascontiguousarray(cur)
            lib.gdm_png_unfilter_row(ftype, cur.ctypes.data,
                                     prev.ctypes.data, row.ctypes.data,
                                     stride, bpp)
        else:
            raise ValueError(f"{path}: PNG filter type {ftype} in row {y}")
        prev = row
    return out


_JPEG_ERRORS = {
    1: (ValueError, "not a JPEG file"),
    2: (ValueError, "corrupt or truncated JPEG data"),
    3: (NotImplementedError, "progressive JPEG whose scans leave low "
                             "coefficients unrefined (libjpeg-turbo block-"
                             "smooths them) is not ported"),
    4: (NotImplementedError, "arithmetic-coded JPEG decode is not ported"),
    5: (NotImplementedError, "JPEG sample precision other than 8 bits is "
                             "not ported"),
    6: (NotImplementedError, "unsupported JPEG (lossless, hierarchical, "
                             "4 components or chroma layout)"),
    7: (ValueError, "JPEG scan refers to a missing table"),
    9: (ValueError, "progressive JPEG scans out of sequence (a scan "
                    "refines coefficients no earlier scan sent)"),
}


def _jpeg_lib():
    from gdm_tpu_torch import _build

    lib = _build.load("jpeg")
    p, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.gdm_jpeg_info.argtypes = [p, i64, p]
    lib.gdm_jpeg_info.restype = ctypes.c_int
    lib.gdm_jpeg_decode.argtypes = [p, i64, p, i64, ctypes.c_int]
    lib.gdm_jpeg_decode.restype = ctypes.c_int
    lib.gdm_jpeg_encode.argtypes = [p, ctypes.c_int, ctypes.c_int,
                                    ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                    ctypes.c_int, p, i64]
    lib.gdm_jpeg_encode.restype = i64
    return lib


def _jpeg_check(path: str, code: int) -> None:
    if code:
        err, msg = _JPEG_ERRORS.get(code, (ValueError, f"error {code}"))
        raise err(f"{path}: {msg}")


def decode_jpeg(path: str, data: bytes, mode: str = "color") -> np.ndarray:
    """A JPEG as ``cv2.imread`` decodes it before the EXIF orientation:
    mode "color" [H, W, 3] uint8 RGB (gray replicated), "gray" [H, W]
    (the luma plane, or libjpeg's RGB->gray of an Adobe RGB file) or
    "unchanged" ([H, W] for a gray file, [H, W, 3] BGR)."""
    lib = _jpeg_lib()
    buf = np.frombuffer(data, np.uint8)
    info = np.zeros(3, np.int32)
    _jpeg_check(path, lib.gdm_jpeg_info(buf.ctypes.data, buf.size,
                                        info.ctypes.data))
    w, h, nc = (int(v) for v in info)
    gray = mode == "gray" or (mode == "unchanged" and nc == 1)
    out = np.empty((h, w) if gray else (h, w, 3), np.uint8)
    _jpeg_check(path, lib.gdm_jpeg_decode(buf.ctypes.data, buf.size,
                                          out.ctypes.data, out.size,
                                          int(gray)))
    return np.ascontiguousarray(out[..., ::-1]) if (
        mode == "unchanged" and not gray) else out


def imwrite_jpeg(path: str, img: np.ndarray, quality: int = 95,
                 subsample: bool = True, restart_interval: int = 0) -> None:
    """Write a uint8 RGB [H,W,3] or gray [H,W] image as a baseline JPEG:
    the standard tables at ``quality`` (libjpeg scaling), 4:2:0 chroma
    (4:4:4 with ``subsample=False``), RST markers every
    ``restart_interval`` MCUs when > 0."""
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8 or img.ndim not in (2, 3) or (
            img.ndim == 3 and img.shape[2] != 3):
        raise ValueError(f"imwrite_jpeg: unsupported array {img.dtype} "
                         f"{img.shape}")
    h, w = img.shape[:2]
    c = 1 if img.ndim == 2 else 3
    cap = 2 * img.size + 4096
    out = np.empty(cap, np.uint8)
    n = _jpeg_lib().gdm_jpeg_encode(img.ctypes.data, w, h, c, int(quality),
                                    int(subsample), int(restart_interval),
                                    out.ctypes.data, cap)
    if n < 0:
        raise ValueError(f"imwrite_jpeg: encoder error {n} on {img.shape}")
    with open(path, "wb") as f:
        f.write(out[:n].tobytes())


def _read(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


# Adam7 passes: (first column, first row, column step, row step)
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def _unpack(rows: np.ndarray, w: int, c: int, depth: int) -> np.ndarray:
    """Unfiltered rows [h, stride] -> samples [h, w, c]: uint16 at bit
    depth 16, else uint8 (1/2/4-bit samples unpacked MSB first)."""
    h = rows.shape[0]
    if depth == 16:
        samples = rows.view(">u2").astype(np.uint16)
    elif depth == 8:
        samples = rows
    else:
        shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
        samples = (rows[:, :, None] >> shifts) & np.uint8((1 << depth) - 1)
        samples = samples.reshape(h, -1)[:, :w * c]
    return samples.reshape(h, w, c)


def _scanlines(path, raw, pos, w, h, c, depth):
    """Samples [h, w, c] of the h filtered scanlines at ``raw[pos:]``, and
    the bytes they took."""
    stride = (w * c * depth + 7) // 8
    n = h * (stride + 1)
    if raw.size < pos + n:
        raise ValueError(f"{path}: PNG image data too short")
    rows = unfilter(path, raw[pos:pos + n].reshape(h, stride + 1),
                    max(1, c * depth // 8))
    return _unpack(rows, w, c, depth), n


def _image_data(path, raw, w, h, c, depth, interlace):
    """Samples [h, w, c] of the decompressed IDAT stream: one run of
    scanlines, or Adam7's seven passes, each filtered on its own (a pass
    of no rows or no columns has no bytes)."""
    if not interlace:
        return _scanlines(path, raw, 0, w, h, c, depth)[0]
    out = np.empty((h, w, c), np.uint16 if depth == 16 else np.uint8)
    pos = 0
    for x0, y0, dx, dy in _ADAM7:
        pw, ph = (w - x0 + dx - 1) // dx, (h - y0 + dy - 1) // dy
        if pw > 0 and ph > 0:
            out[y0::dy, x0::dx], n = _scanlines(path, raw, pos, pw, ph, c,
                                                depth)
            pos += n
    return out


class _Png:
    """A decoded PNG: ``samples`` [H, W, C] (uint8, or uint16 at bit
    depth 16; palette indices for colour type 3), its header, palette,
    tRNS body, the EXIF block libpng keeps (a list of 0 or 1), the file
    gamma libpng reads (x 1e5, None without one) and the sBIT body."""

    def __init__(self, samples, color_type, bit_depth, palette, trns, exif,
                 gamma, sbit):
        self.samples = samples
        self.color_type = color_type
        self.bit_depth = bit_depth
        self.palette = palette
        self.trns = trns
        self.exif = exif
        self.gamma = gamma
        self.sbit = sbit


def _file_gamma(chunks):
    """libpng's file gamma (x 1e5) from the chunks before PLTE and the
    image data: sRGB's 45455 wherever that chunk lies among them, else
    the first gAMA's value (none where it is 0 or past 2^31 - 1; later
    gAMAs are ignored)."""
    gamma = seen = None
    for ctype, body in chunks:
        if ctype in (b"PLTE", b"IDAT"):
            break
        if ctype == b"sRGB":
            return 45455
        if ctype == b"gAMA" and not seen and len(body) == 4:
            seen, g = True, struct.unpack(">I", body)[0]
            gamma = g if 0 < g <= 0x7FFFFFFF else None
    return gamma


def _decode(path: str, data: bytes) -> _Png:
    if data[:8] != _SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    header, palette, trns, sbit, idat = None, None, None, None, []
    chunks = list(_chunks(path, data))
    for ctype, body in chunks:
        if ctype == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif ctype == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif ctype == b"tRNS":
            trns = body
        elif ctype == b"sBIT":
            sbit = body
        elif ctype == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError(f"{path}: PNG without IHDR")
    w, h, depth, color_type, _, _, interlace = header
    if color_type not in _CHANNELS:
        raise ValueError(f"{path}: PNG colour type {color_type}")
    if interlace > 1:
        raise ValueError(f"{path}: PNG interlace method {interlace}")
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    samples = _image_data(path, raw, w, h, _CHANNELS[color_type], depth,
                          interlace)
    if color_type == 3:
        if palette is None:
            raise ValueError(f"{path}: palette PNG without PLTE")
        if samples.max(initial=0) >= len(palette):
            raise ValueError(f"{path}: palette index out of range")
    return _Png(samples, color_type, depth, palette, trns,
                exif.png_exif_block(chunks), _file_gamma(chunks), sbit)


def _gray8(png: _Png) -> np.ndarray:
    """[H, W, C] samples of a gray or colour PNG at 8 bits: 16-bit keeps
    the high byte, 1/2/4-bit gray scales to 0..255."""
    s = png.samples
    if png.bit_depth == 16:
        return (s >> 8).astype(np.uint8)
    if png.bit_depth < 8 and png.color_type == 0:
        return s * np.uint8(255 // ((1 << png.bit_depth) - 1))
    return s


def _png_rgb(png: _Png) -> np.ndarray:
    """IMREAD_COLOR in RGB order: alpha dropped, palette and gray
    expanded."""
    if png.color_type == 3:
        return png.palette[png.samples[..., 0]]
    s = _gray8(png)
    if png.color_type in (0, 4):                 # gray (+ alpha)
        return np.repeat(s[..., :1], 3, axis=-1)
    return np.ascontiguousarray(s[..., :3])


# libpng's png_set_rgb_to_gray(png, 1, 0.299, 0.587), which OpenCV calls:
# weights in 1/32768 (its fixed-point conversion truncates), blue takes
# the rest of 32768
_GRAY_R, _GRAY_G = 29900 * 32768 // 100000, 58700 * 32768 // 100000
_GRAY_B = 32768 - _GRAY_R - _GRAY_G


def _recip(g: int) -> int:
    """libpng's png_reciprocal of a x 1e5 fixed-point gamma."""
    return int(math.floor(1e10 / g + .5))


def _gamma_table(gamma: int, bits: int, wide: bool) -> np.ndarray:
    """libpng's gamma table of ``bits``-bit inputs to 16 (``wide``) or 8
    bits: round(top_out * (i / top_in) ** (gamma / 1e5)), the identity
    (rescaled to 16 bits) where the gamma lies within 5% of 1."""
    top, out_top = (1 << bits) - 1, 65535 if wide else 255
    i = np.arange(top + 1)
    if 95000 <= gamma <= 105000:
        return (i * 65535 + (top + 1) // 2) // top if wide else i
    t = np.floor(out_top * np.power(i * (1.0 / top), gamma * .00001) + .5)
    return t.astype(np.int64)


def _gray_table(gamma: int, shift: int) -> np.ndarray:
    """libpng's png_build_16to8_table over 16 - shift bit inputs: each
    8-bit output i (as i * 257) up to the input at which the gamma curve
    crosses i * 257 + 128, rounded to 16 - shift bits."""
    top = (1 << (16 - shift)) - 1
    table = np.full(top + 1, 65535, np.int64)
    last = 0
    for i in range(255):
        v = i * 257 + 128
        if 0 < v < 65535:
            v = int(math.floor(65535 * math.pow(v / 65535., gamma * .00001)
                               + .5))
        bound = (v * top + 32768) // 65535 + 1
        table[last:bound] = i * 257
        last = max(last, bound)
    return table


def _rgb_to_gray(rgb: np.ndarray, png: _Png) -> np.ndarray:
    """libpng's png_do_rgb_to_gray of [..., 3] int64 samples, then its
    strip to 8 bits.  Without a file gamma beyond 5% of 1 the weighted
    sum truncates at 8 bits and rounds at 16; with one (the file gamma
    or its reciprocal, the screen gamma, beyond 5% of 1), each sample
    goes through the file's gamma to linear, the rounded sum back, and
    a pixel with R = G = B through the file-to-screen table, over
    16-bit tables of 16 - shift bits (shift: the insignificant bits of
    sBIT, at least 5, at most 8)."""
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    wide = png.bit_depth == 16
    if png.gamma is None or (95000 <= png.gamma <= 105000
                             and 95000 <= _recip(png.gamma) <= 105000):
        y = _GRAY_R * r + _GRAY_G * g + _GRAY_B * b
        return ((y + 16384) >> 15 >> 8) if wide else y >> 15
    screen = _recip(png.gamma)
    shift = 0
    if wide:
        sig = max(png.sbit[:3]) if png.sbit and len(png.sbit) >= 3 else 0
        shift = min(max(16 - sig if 0 < sig < 16 else 0, 5), 8)
        # png_product2 of the file and screen gammas
        same = _gray_table(int(math.floor(png.gamma * 1e-5 * screen + .5)),
                           shift)
    else:
        # png_reciprocal2 of the file and screen gammas
        same = _gamma_table(int(math.floor(1e15 / png.gamma / screen + .5)),
                            8, False)
    bits = 16 - shift if wide else 8
    to1 = _gamma_table(screen, bits, wide)
    from1 = _gamma_table(_recip(screen), bits, wide)
    y = (_GRAY_R * to1[r >> shift] + _GRAY_G * to1[g >> shift]
         + _GRAY_B * to1[b >> shift] + 16384) >> 15
    y = np.where((r == g) & (r == b), same[r >> shift], from1[y >> shift])
    return y >> 8 if wide else y


def _png_gray(png: _Png) -> np.ndarray:
    """IMREAD_GRAYSCALE: alpha stripped; colour and palette samples
    through libpng's rgb_to_gray (``_rgb_to_gray``)."""
    if png.color_type in (0, 4):
        return np.ascontiguousarray(_gray8(png)[..., 0])
    rgb = (png.palette[png.samples[..., 0]] if png.color_type == 3
           else png.samples[..., :3]).astype(np.int64)
    return _rgb_to_gray(rgb, png).astype(np.uint8)


def _trns_alpha(png: _Png) -> np.ndarray:
    """[H, W] alpha that libpng's tRNS-to-alpha expansion gives a colour
    or palette image."""
    s = png.samples
    if png.color_type == 3:
        table = np.full(256, 255, np.uint8)
        a = np.frombuffer(png.trns, np.uint8)[:256]
        table[:a.size] = a
        return table[s[..., 0]]
    key = np.array(struct.unpack(">3H", png.trns[:6]), np.uint32)
    if png.bit_depth == 8:
        key &= 0xFF
    top = 65535 if png.bit_depth == 16 else 255
    return np.where((s == key).all(-1), 0, top).astype(s.dtype)


def _png_unchanged(png: _Png) -> np.ndarray:
    """IMREAD_UNCHANGED: gray as one channel (1/2/4-bit scaled to
    0..255), gray+alpha as BGRA with the gray repeated, colour and
    palette as BGR, or BGRA where the file has alpha or a tRNS chunk;
    16-bit samples stay 16-bit."""
    s = png.samples
    if png.color_type == 0:
        return np.ascontiguousarray(_gray8(png)[..., 0]) \
            if png.bit_depth < 8 else np.ascontiguousarray(s[..., 0])
    if png.color_type == 4:
        return np.ascontiguousarray(s[..., [0, 0, 0, 1]])
    if png.color_type == 6:
        return np.ascontiguousarray(s[..., [2, 1, 0, 3]])
    rgb = png.palette[s[..., 0]] if png.color_type == 3 else s
    bgr = rgb[..., ::-1]
    if png.trns is None or (png.color_type == 2 and len(png.trns) < 6):
        return np.ascontiguousarray(bgr)
    return np.concatenate([bgr, _trns_alpha(png)[..., None]], axis=-1)


def imread(path: str, mode: str = "color") -> np.ndarray:
    """``cv2.imread(path, flag)`` for ``mode`` "color" (IMREAD_COLOR, in
    RGB order), "gray" (IMREAD_GRAYSCALE) or "unchanged"
    (IMREAD_UNCHANGED, BGR(A) order), of a PNG or a JPEG."""
    if mode not in ("color", "gray", "unchanged"):
        raise ValueError(f"imread: mode {mode!r}")
    data = _read(path)
    if data[:3] == b"\xff\xd8\xff":
        img = decode_jpeg(path, data, mode)
        blocks = exif.jpeg_exif_blocks(data)
    else:
        png = _decode(path, data)
        img = {"color": _png_rgb, "gray": _png_gray,
               "unchanged": _png_unchanged}[mode](png)
        blocks = png.exif
    if mode == "unchanged" or not blocks:
        return img
    return exif.apply_orientation(img, exif.orientation(blocks))


def imread_rgb(path: str) -> np.ndarray:
    """[H,W,3] uint8 RGB: ``IMREAD_COLOR`` + BGR->RGB of a PNG or JPEG."""
    return imread(path, "color")


def imread_u16(path: str) -> np.ndarray:
    """``IMREAD_UNCHANGED`` as uint16: [H,W] for gray files (BOP depth
    PNGs are 16-bit unsigned), [H,W,3|4] BGR(A) for colour ones."""
    return imread(path, "unchanged").astype(np.uint16, copy=False)


def imread_mask(path: str) -> np.ndarray:
    """[H,W] uint8 ``IMREAD_GRAYSCALE`` (BOP masks are 8-bit gray)."""
    return imread(path, "gray")


def _chunk(ctype: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + ctype + body
            + struct.pack(">I", zlib.crc32(ctype + body)))


def imwrite_png(path: str, img: np.ndarray) -> None:
    """Write uint8 gray [H,W], RGB [H,W,3] or RGBA [H,W,4], or uint16
    gray [H,W], as a non-interlaced PNG (every row Up-filtered)."""
    img = np.asarray(img)
    if img.dtype not in (np.uint8, np.uint16) or img.ndim not in (2, 3):
        raise ValueError(f"imwrite_png: unsupported array {img.dtype} "
                         f"{img.shape}")
    h, w = img.shape[:2]
    c = 1 if img.ndim == 2 else img.shape[2]
    color_type = {1: 0, 3: 2, 4: 6}.get(c)
    if color_type is None or (img.dtype == np.uint16 and c != 1):
        raise ValueError(f"imwrite_png: unsupported array {img.dtype} "
                         f"{img.shape}")
    depth = 16 if img.dtype == np.uint16 else 8
    rows = np.ascontiguousarray(img.astype(">u2") if depth == 16 else img)
    rows = rows.view(np.uint8).reshape(h, -1)
    up = np.diff(rows, axis=0, prepend=np.zeros((1, rows.shape[1]),
                                                 np.uint8))
    raw = np.concatenate([np.full((h, 1), 2, np.uint8), up], axis=1)
    with open(path, "wb") as f:
        f.write(_SIGNATURE)
        f.write(_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth,
                                            color_type, 0, 0, 0)))
        f.write(_chunk(b"IDAT", zlib.compress(raw.tobytes(), 6)))
        f.write(_chunk(b"IEND", b""))
