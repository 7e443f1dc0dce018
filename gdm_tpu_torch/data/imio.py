"""Image decode and encode on the host: a PNG codec in numpy and zlib.

Counterpart of gdm_tpu/data/imio.py, which decodes with cv2; the GPU
host has neither cv2 nor PIL.  The decoders return what cv2.imread
returns for the same file (the tests hold them bit-equal on 8-bit RGB,
RGBA, gray, palette and 16-bit gray files):

  * ``imread_rgb`` is ``IMREAD_COLOR`` + BGR->RGB: alpha is dropped,
    palette and gray expand to RGB, 16-bit samples keep their high byte,
    1/2/4-bit gray scales to 0..255;
  * ``imread_u16`` is ``IMREAD_UNCHANGED`` of a single-channel (depth)
    PNG, as uint16;
  * ``imread_mask`` is ``IMREAD_GRAYSCALE`` of a single-channel PNG.

Unfiltering: None, Sub (a wrapping cumsum over each byte lane) and Up
run on whole rows in numpy; Average and Paeth are sequential per byte
and run in a small C++ row loop (``csrc/png_unfilter.cpp``).  Interlaced
PNGs and JPEG input raise NotImplementedError naming the file: the BOP
``test`` splits of LM-O and YCB-V are non-interlaced PNG.  A missing file
raises FileNotFoundError, as the cv2 readers do.
"""

from __future__ import annotations

import ctypes
import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}   # by PNG colour type


class _Png:
    """A decoded PNG: ``samples`` [H, W, C] (uint8, or uint16 at bit
    depth 16; palette indices for colour type 3) and its header."""

    def __init__(self, samples, color_type, bit_depth, palette):
        self.samples = samples
        self.color_type = color_type
        self.bit_depth = bit_depth
        self.palette = palette


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


def _decode(path: str) -> _Png:
    with open(path, "rb") as f:
        data = f.read()
    if data[:3] == b"\xff\xd8\xff":
        raise NotImplementedError(
            f"{path}: JPEG decode is not ported (PNG only)")
    if data[:8] != _SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    header, palette, idat = None, None, []
    for ctype, body in _chunks(path, data):
        if ctype == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif ctype == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif ctype == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError(f"{path}: PNG without IHDR")
    w, h, depth, color_type, _, _, interlace = header
    if interlace:
        raise NotImplementedError(
            f"{path}: interlaced PNG decode is not ported")
    if color_type not in _CHANNELS:
        raise ValueError(f"{path}: PNG colour type {color_type}")
    c = _CHANNELS[color_type]
    stride = (w * c * depth + 7) // 8
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size < h * (stride + 1):
        raise ValueError(f"{path}: PNG image data too short")
    rows = unfilter(path, raw[:h * (stride + 1)].reshape(h, stride + 1),
                    max(1, c * depth // 8))
    if depth == 16:
        samples = rows.view(">u2").astype(np.uint16)
    elif depth == 8:
        samples = rows
    else:                                   # 1/2/4-bit samples, MSB first
        shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
        samples = (rows[:, :, None] >> shifts) & np.uint8((1 << depth) - 1)
        samples = samples.reshape(h, -1)[:, :w * c]
    samples = samples.reshape(h, w, c)
    if color_type == 3:
        if palette is None:
            raise ValueError(f"{path}: palette PNG without PLTE")
        if samples.max(initial=0) >= len(palette):
            raise ValueError(f"{path}: palette index out of range")
    return _Png(samples, color_type, depth, palette)


def _gray8(png: _Png) -> np.ndarray:
    """[H, W, C] samples of a gray or colour PNG at 8 bits: 16-bit keeps
    the high byte, 1/2/4-bit gray scales to 0..255."""
    s = png.samples
    if png.bit_depth == 16:
        return (s >> 8).astype(np.uint8)
    if png.bit_depth < 8 and png.color_type == 0:
        return s * np.uint8(255 // ((1 << png.bit_depth) - 1))
    return s


def imread_rgb(path: str) -> np.ndarray:
    """[H,W,3] uint8 RGB (alpha dropped, palette and gray expanded)."""
    png = _decode(path)
    if png.color_type == 3:
        return png.palette[png.samples[..., 0]]
    s = _gray8(png)
    if png.color_type in (0, 4):                 # gray (+ alpha)
        return np.repeat(s[..., :1], 3, axis=-1)
    return np.ascontiguousarray(s[..., :3])


def _single_channel(path: str, png: _Png) -> None:
    if png.color_type != 0:
        raise ValueError(f"{path}: want a single-channel gray PNG, got "
                         f"colour type {png.color_type}")


def imread_u16(path: str) -> np.ndarray:
    """[H,W] uint16 depth counts (BOP depth PNGs are 16-bit unsigned)."""
    png = _decode(path)
    _single_channel(path, png)
    return _gray8(png)[..., 0].astype(np.uint16) if png.bit_depth < 16 \
        else png.samples[..., 0]


def imread_mask(path: str) -> np.ndarray:
    """[H,W] uint8 visibility mask (BOP masks are 8-bit grayscale)."""
    png = _decode(path)
    _single_channel(path, png)
    return np.ascontiguousarray(_gray8(png)[..., 0])


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
