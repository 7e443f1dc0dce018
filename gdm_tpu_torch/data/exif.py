"""EXIF orientation as ``cv2.imread`` reads and applies it.

Counterpart of what OpenCV's image codecs do before ``imread`` returns
(the JAX package's loader reads through cv2; the GPU host has no cv2):

  * ``IMREAD_COLOR`` and ``IMREAD_GRAYSCALE`` apply the orientation tag,
    ``IMREAD_UNCHANGED`` does not;
  * a JPEG's EXIF blocks are the APP1 segments that start with
    ``Exif\\0\\0`` and come before the first SOS, in file order; a PNG's is
    the first ``eXIf`` chunk (before or after the image data) that libpng
    keeps: at least 4 bytes that open with ``II*\\0`` or ``MM\\0*``;
  * each block is a TIFF header and its first IFD, read as OpenCV's
    ``ExifReader`` reads it: ``II`` is little-endian and anything else
    big-endian; the header's magic must be 42; entries are read in
    order and the first entry of a tag is kept, across blocks too; an
    entry that OpenCV decodes (strings, rationals) and that points
    outside the block ends that block's reading, keeping the entries
    before it;
  * the orientation is the 16-bit word at the entry's value field,
    whatever its type and count; 1-8 transform the image and any other
    value leaves it as decoded.

The eight transforms are index operations on [H, W(, C)] arrays
(``apply_orientation``), in OpenCV's order: a transpose first, then a
flip.
"""

from __future__ import annotations

import struct

import numpy as np

ORIENTATION = 0x0112

# Tags whose value OpenCV's ExifReader decodes, by how it reads them; an
# out-of-range read of any of them ends the block.  Other tags are
# skipped without touching their value.
_STRING_TAGS = (0x010E, 0x010F, 0x0110, 0x0131, 0x0132, 0x8298)
_RATIONAL_TAGS = {0x011A: 1, 0x011B: 1, 0x013E: 2, 0x013F: 6, 0x0211: 3,
                  0x0214: 6}
_U16_TAGS = (ORIENTATION, 0x0128, 0x0213)


class _OutOfRange(Exception):
    pass


class _Tiff:
    def __init__(self, data: bytes):
        self.data = data
        self.little = data[:1] == b"I" and data[1:2] in (b"", b"I")

    def u16(self, off: int) -> int:
        if off + 1 >= len(self.data):
            raise _OutOfRange
        b = self.data[off:off + 2]
        return b[0] | b[1] << 8 if self.little else b[0] << 8 | b[1]

    def u32(self, off: int) -> int:
        if off + 3 >= len(self.data):
            raise _OutOfRange
        return struct.unpack("<I" if self.little else ">I",
                             self.data[off:off + 4])[0]


def _read_entry(t: _Tiff, off: int, tag: int):
    """Value of the IFD entry at ``off`` as OpenCV reads it, or None for
    a tag it skips; raises _OutOfRange where OpenCV's reader throws."""
    if tag in _U16_TAGS:
        return t.u16(off + 8)
    if tag in _STRING_TAGS:
        size = t.u32(off + 4)
        start = t.u32(off + 8) if size > 4 else 8
        if start > len(t.data) or start + size > len(t.data):
            raise _OutOfRange
        return None
    if tag in _RATIONAL_TAGS:
        at = t.u32(off + 8)
        for i in range(2 * _RATIONAL_TAGS[tag]):
            t.u32(at + 4 * i)
        return None
    return None


def parse_tiff(data: bytes, tags: dict) -> None:
    """Add the first IFD's entries of one EXIF block to ``tags`` (tag ->
    value; an entry already there is kept)."""
    t = _Tiff(data)
    try:
        if t.u16(2) != 42:
            return
        off = t.u32(4)
        n = t.u16(off)
        off += 2
        for _ in range(n):
            tag = t.u16(off)
            value = _read_entry(t, off, tag)
            tags.setdefault(tag, value)
            off += 12
    except _OutOfRange:
        return


def jpeg_exif_blocks(data: bytes) -> list[bytes]:
    """TIFF blocks of the ``Exif\\0\\0`` APP1 segments before the first
    SOS of a JPEG file."""
    out, pos, n = [], 2, len(data)
    while pos + 4 <= n:
        if data[pos] != 0xFF:
            pos += 1
            continue
        marker = data[pos + 1]
        if marker == 0xFF:
            pos += 1
            continue
        if marker in (0x01, 0xD8) or 0xD0 <= marker <= 0xD7:
            pos += 2
            continue
        if marker in (0xD9, 0xDA):
            break
        length = data[pos + 2] << 8 | data[pos + 3]
        seg = data[pos + 4:pos + 2 + length]
        if marker == 0xE1 and seg[:6] == b"Exif\0\0":
            out.append(seg[6:])
        pos += 2 + length
    return out


def png_exif_block(chunks) -> list[bytes]:
    """The ``eXIf`` chunk libpng keeps, from (type, body) pairs: the
    first of at least 4 bytes with a valid TIFF byte-order header."""
    for ctype, body in chunks:
        if ctype == b"eXIf" and len(body) >= 4 and body[:4] in (
                b"II*\0", b"MM\0*"):
            return [body]
    return []


def orientation(blocks) -> int:
    """The orientation tag of a file's EXIF blocks, 1 where absent."""
    tags: dict = {}
    for block in blocks:
        parse_tiff(block, tags)
    value = tags.get(ORIENTATION)
    return 1 if value is None else value


def apply_orientation(img: np.ndarray, orient: int) -> np.ndarray:
    """``img`` [H, W(, C)] as OpenCV's ExifTransform leaves it (orient
    1-8; any other value returns ``img``)."""
    if orient in (5, 6, 7, 8):
        img = img.swapaxes(0, 1)
    if orient in (2, 6):
        img = img[:, ::-1]
    elif orient in (3, 7):
        img = img[::-1, ::-1]
    elif orient in (4, 8):
        img = img[::-1]
    return np.ascontiguousarray(img)

