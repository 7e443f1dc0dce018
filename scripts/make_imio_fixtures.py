"""Write the image files of tests/data/imio/ and their cv2 manifest.

The port's readers (gdm_tpu_torch/data/imio.py) are held against
cv2.imread on these files where cv2 is absent (the GPU host): each file
comes with cv2's result for every read flag.  Run on a machine with cv2
and PIL, from the repo root:

    python scripts/make_imio_fixtures.py [--out tests/data/imio]

It writes progressive JPEGs of each subsampling (libjpeg's default scan
script, so with successive approximation; one with restart markers, one
written by PIL), an interlaced (Adam7) RGB PNG and a 16-bit gray one, a
baseline JPEG with EXIF orientation 6, a PNG with an ``eXIf``
orientation 8, a 16-bit RGB PNG with gAMA and sBIT and a palette PNG
with sRGB (read gray through libpng's gamma tables), and
``manifest.json``: for each file and each of "color"
(IMREAD_COLOR converted to RGB, what gdm_tpu.data.imio.imread_rgb
returns), "gray" (IMREAD_GRAYSCALE) and "unchanged" (IMREAD_UNCHANGED),
the array's shape, dtype and sha256.  The files are deterministic for a
given cv2 and PIL; tests/test_torch_imio_forms.py checks the manifest
against this machine's cv2.
"""

from __future__ import annotations

import argparse
import hashlib
import io
import json
import os
import os.path as osp
import struct
import zlib

import cv2
import numpy as np
from PIL import Image

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
FLAGS = {"color": cv2.IMREAD_COLOR, "gray": cv2.IMREAD_GRAYSCALE,
         "unchanged": cv2.IMREAD_UNCHANGED}
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
         (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def textured(h, w, seed):
    """An RGB frame with gradients, noise and a flat block."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[:h, :w]
    img = np.stack([(xx * 2.1) % 256, (yy * 2.7) % 256,
                    ((xx + yy) * 1.3) % 256], -1)
    img = (img + rng.randn(h, w, 3) * 12).clip(0, 255).astype(np.uint8)
    img[h // 5:h // 2, w // 6:w // 2] = [250, 10, 30]
    return img


def chunk(ctype: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + ctype + body
            + struct.pack(">I", zlib.crc32(ctype + body)))


def tiff_orientation(orient: int, order: bytes) -> bytes:
    """A TIFF block whose first IFD holds one Orientation entry."""
    e = "<" if order == b"II" else ">"
    return (order + struct.pack(e + "HI", 42, 8) + struct.pack(e + "H", 1)
            + struct.pack(e + "HHIHH", 0x0112, 3, 1, orient, 0)
            + struct.pack(e + "I", 0))


def png_bytes(img: np.ndarray, extra: bytes = b"", interlace: int = 1,
              color_type: int | None = None, palette=None) -> bytes:
    """8-bit gray/RGB, 16-bit gray/RGB or palette-index [H, W] array ->
    PNG bytes (Adam7 with ``interlace``, every row filter 0), with the
    chunks ``extra`` (and PLTE) before the image data."""
    h, w = img.shape[:2]
    a = img.reshape(h, w, -1)
    if color_type is None:
        color_type = {1: 0, 3: 2}[a.shape[2]]
    depth = 16 if a.dtype == np.uint16 else 8
    body = b""
    for x0, y0, dx, dy in ADAM7 if interlace else ((0, 0, 1, 1),):
        sub = a[y0::dy, x0::dx]
        if sub.size == 0:
            continue
        rows = sub.astype(">u2") if depth == 16 else sub
        for r in rows.reshape(sub.shape[0], -1):
            body += b"\0" + r.tobytes()
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color_type,
                                         0, 0, interlace)) + extra
            + (b"" if palette is None else chunk(b"PLTE", palette.tobytes()))
            + chunk(b"IDAT", zlib.compress(body, 9)) + chunk(b"IEND", b""))


def adam7_png(img: np.ndarray, exif: bytes | None = None) -> bytes:
    """An interlaced PNG with an ``eXIf`` chunk before the image data."""
    return png_bytes(img, chunk(b"eXIf", exif) if exif else b"")


def jpeg_with_exif(data: bytes, tiff: bytes) -> bytes:
    seg = b"Exif\0\0" + tiff
    return data[:2] + b"\xff\xe1" + struct.pack(">H", len(seg) + 2) + seg \
        + data[2:]


def cv2_jpeg(img, **params) -> bytes:
    p = [cv2.IMWRITE_JPEG_QUALITY, params.get("quality", 75),
         cv2.IMWRITE_JPEG_PROGRESSIVE, params.get("progressive", 1),
         cv2.IMWRITE_JPEG_RST_INTERVAL, params.get("restart", 0)]
    if img.ndim == 3:
        p += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, params["sampling"]]
        img = img[..., ::-1]
    ok, enc = cv2.imencode(".jpg", img, p)
    assert ok
    return enc.tobytes()


def files() -> dict[str, bytes]:
    img = textured(61, 83, 0)
    s = {k: getattr(cv2, f"IMWRITE_JPEG_SAMPLING_FACTOR_{k}")
         for k in ("420", "422", "444")}
    out = {f"prog_{k}.jpg": cv2_jpeg(img, sampling=v) for k, v in s.items()}
    out["prog_gray.jpg"] = cv2_jpeg(img[..., 1])
    out["prog_420_rst5_q95.jpg"] = cv2_jpeg(img, sampling=s["420"],
                                            restart=5, quality=95)
    buf = io.BytesIO()
    Image.fromarray(textured(47, 59, 1)).save(buf, "JPEG", quality=50,
                                              progressive=True)
    out["prog_pil_q50.jpg"] = buf.getvalue()
    out["adam7_rgb.png"] = adam7_png(textured(29, 37, 2))
    depth = (np.random.RandomState(3).rand(21, 19) * 3000).astype(np.uint16)
    out["adam7_gray16.png"] = adam7_png(depth)
    out["exif6.jpg"] = jpeg_with_exif(
        cv2_jpeg(textured(33, 51, 4), sampling=s["420"], progressive=0),
        tiff_orientation(6, b"MM"))
    out["exif8_adam7.png"] = adam7_png(textured(13, 22, 5),
                                       tiff_orientation(8, b"II"))
    # libpng reads colour as gray through its gamma tables here
    rgb16 = (textured(17, 23, 6).astype(np.uint16) * 257
             + np.random.RandomState(6).randint(0, 257, (17, 23, 3))
             ).astype(np.uint16)
    out["gamma_rgb16_sbit12.png"] = png_bytes(
        rgb16, chunk(b"gAMA", struct.pack(">I", 45455))
        + chunk(b"sBIT", bytes([12, 12, 12])), interlace=0)
    rng = np.random.RandomState(7)
    out["srgb_palette.png"] = png_bytes(
        rng.randint(0, 40, (19, 25)).astype(np.uint8),
        chunk(b"sRGB", b"\0"), interlace=0, color_type=3,
        palette=rng.randint(0, 256, (40, 3)).astype(np.uint8))
    return out


def describe(arr: np.ndarray) -> dict:
    arr = np.ascontiguousarray(arr)
    return {"shape": list(arr.shape), "dtype": str(arr.dtype),
            "sha256": hashlib.sha256(arr.tobytes()).hexdigest()}


def cv2_results(path: str) -> dict:
    """{flag name: shape, dtype and sha256 of cv2.imread's array} ("color"
    in RGB order)."""
    out = {}
    for name, flag in FLAGS.items():
        arr = cv2.imread(path, flag)
        if arr is None:
            raise RuntimeError(f"cv2 cannot read {path}")
        if name == "color":
            arr = arr[..., ::-1]
        out[name] = describe(arr)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=osp.join(ROOT, "tests", "data", "imio"))
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    manifest = {"note": "cv2.imread's result for each file and flag; "
                        "'color' is IMREAD_COLOR in RGB order. Written by "
                        "scripts/make_imio_fixtures.py.",
                "cv2": cv2.__version__, "files": {}}
    for name, data in sorted(files().items()):
        path = osp.join(args.out, name)
        with open(path, "wb") as f:
            f.write(data)
        manifest["files"][name] = cv2_results(path)
    with open(osp.join(args.out, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
        f.write("\n")
    total = sum(osp.getsize(osp.join(args.out, n)) for n in os.listdir(
        args.out))
    print(f"{len(manifest['files'])} files and manifest.json in {args.out}"
          f" ({total} bytes)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
