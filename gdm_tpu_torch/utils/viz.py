"""Pose overlays: project points, draw them and the box wireframe.

Counterpart of gdm_tpu/utils/viz.py (the reference's
utils/basic_utils.py:355-440 drawing helpers), without cv2: the filled
circles of ``cv2.circle(..., -1)`` and the closed polylines of
``cv2.polylines`` (thickness 1, LINE_8) are drawn here with OpenCV's own
integer algorithms (drawing.cpp ``Circle``, ``Line`` and its
``LineIterator``, ``clipLine``), so every pixel is the one cv2 sets.
Host numpy; visualisation is an offline aid, never on the device path.
Inputs are never mutated.
"""

from __future__ import annotations

import numpy as np

# one colour per YCB-V object id (1-based); id 0 / background grey
_LABEL_COLORS = np.array(
    [
        (128, 128, 128), (255, 0, 0), (0, 255, 0), (0, 0, 255),
        (255, 255, 0), (255, 0, 255), (0, 255, 255), (128, 0, 0),
        (0, 128, 0), (0, 0, 128), (128, 128, 0), (128, 0, 128),
        (0, 128, 128), (255, 128, 0), (255, 0, 128), (128, 255, 0),
        (0, 255, 128), (128, 0, 255), (0, 128, 255), (255, 128, 128),
        (128, 255, 128), (128, 128, 255),
    ],
    dtype=np.uint8,
)


def label_color(label: int) -> tuple[int, int, int]:
    """RGB colour for an integer class label (wraps past the table)."""
    return tuple(int(c) for c in _LABEL_COLORS[label % len(_LABEL_COLORS)])


def project_p3d(p3d: np.ndarray, K: np.ndarray,
                cam_scale: float = 1.0) -> np.ndarray:
    """[N, 3] camera-frame points -> rounded [N, 2] int32 pixel coords
    (z < 1e-8 divides by 1)."""
    p3d = np.asarray(p3d, np.float64) * cam_scale
    p2d = p3d @ np.asarray(K, np.float64).T
    z = np.where(p2d[:, 2] < 1e-8, 1.0, p2d[:, 2])
    return np.around(p2d[:, :2] / z[:, None]).astype(np.int32)


def _clip_p2ds(p2ds: np.ndarray, h: int, w: int) -> np.ndarray:
    p2ds = np.asarray(p2ds, np.int32).copy()
    p2ds[:, 0] = np.clip(p2ds[:, 0], 0, w - 1)
    p2ds[:, 1] = np.clip(p2ds[:, 1], 0, h - 1)
    return p2ds


def _per_point_colors(color, n: int) -> list:
    if isinstance(color, tuple):
        return [color] * n
    if len(color) != n:
        return [color[0]] * n
    return list(color)


def _fill_circle(img: np.ndarray, cx: int, cy: int, r: int, color) -> None:
    """OpenCV's ``Circle(..., fill=1)``: horizontal spans of the midpoint
    circle, clipped to the image."""
    h, w = img.shape[:2]
    err, dx, dy, plus, minus = 0, r, 0, 1, (r << 1) - 1
    while dx >= dy:
        for y, half in ((cy - dy, dx), (cy + dy, dx), (cy - dx, dy),
                        (cy + dx, dy)):
            xl, xr = max(cx - half, 0), min(cx + half, w - 1)
            if 0 <= y < h and xl <= xr:
                img[y, xl:xr + 1] = color
        dy += 1
        err += plus
        plus += 2
        mask = -1 if err > 0 else 0
        err -= minus & mask
        dx += mask
        minus -= mask & 2


def draw_points(img: np.ndarray, p2ds: np.ndarray, r: int = 1,
                color=(255, 0, 0)) -> np.ndarray:
    """Filled circles of radius ``r`` at [N, 2] (x, y) pixel coords,
    clipped into the image; ``color`` is one RGB tuple or one per point.
    Returns a new image."""
    img = np.ascontiguousarray(img).copy()
    p2ds = _clip_p2ds(p2ds, img.shape[0], img.shape[1])
    for (x, y), c in zip(p2ds, _per_point_colors(color, len(p2ds))):
        _fill_circle(img, int(x), int(y), r,
                     np.asarray([int(v) for v in c][:img.shape[2]],
                                img.dtype))
    return img


def draw_points_label(img: np.ndarray, p2ds: np.ndarray,
                      labels: np.ndarray, r: int = 1) -> np.ndarray:
    """Per-point label-coloured variant (reference ``draw_p2ds_lb``)."""
    return draw_points(img, p2ds, r,
                       [label_color(int(lb)) for lb in np.asarray(labels)])


def paste_points(img: np.ndarray, p2ds: np.ndarray,
                 color=(255, 0, 0)) -> np.ndarray:
    """Single-pixel scatter paste (reference ``paste_p2ds``)."""
    img = np.ascontiguousarray(img).copy()
    p2ds = _clip_p2ds(p2ds, img.shape[0], img.shape[1])
    if isinstance(color, tuple):
        col = np.broadcast_to(np.asarray(color, img.dtype), (len(p2ds), 3))
    else:
        col = np.asarray(color, img.dtype)
        if len(col) != len(p2ds):
            col = np.broadcast_to(col[0], (len(p2ds), 3))
    img[p2ds[:, 1], p2ds[:, 0]] = col
    return img


def _clip_line(w: int, h: int, x1: int, y1: int, x2: int, y2: int):
    """OpenCV's ``clipLine`` (int64 arithmetic, quotients in double
    truncated toward zero): the segment's ends moved onto the image's
    edges, or None when it misses the image."""
    right, bottom = w - 1, h - 1
    c1 = (x1 < 0) + (x1 > right) * 2 + (y1 < 0) * 4 + (y1 > bottom) * 8
    c2 = (x2 < 0) + (x2 > right) * 2 + (y2 < 0) * 4 + (y2 > bottom) * 8
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int(float(a - y1) * float(x2 - x1) / float(y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int(float(a - y2) * float(x2 - x1) / float(y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int(float(a - x1) * float(y2 - y1) / float(x2 - x1))
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int(float(a - x2) * float(y2 - y1) / float(x2 - x1))
                x2 = a
                c2 = 0
    if c1 | c2:
        return None
    return x1, y1, x2, y2


def _line_pixels(w: int, h: int, p1, p2):
    """(xs, ys) of OpenCV's 8-connected ``LineIterator`` from p1 to p2
    (left to right, clipped to the image when an end lies outside)."""
    x1, y1, x2, y2 = (int(v) for v in (*p1, *p2))
    if not (0 <= x1 < w and 0 <= x2 < w and 0 <= y1 < h and 0 <= y2 < h):
        clipped = _clip_line(w, h, x1, y1, x2, y2)
        if clipped is None:
            return [], []
        x1, y1, x2, y2 = clipped
    if x2 < x1:
        x1, y1, x2, y2 = x2, y2, x1, y1
    dx, dy = x2 - x1, y2 - y1
    sy = -1 if dy < 0 else 1
    dy = abs(dy)
    vert = dy > dx
    major, minor = (dy, dx) if vert else (dx, dy)
    err = major - 2 * minor
    xs, ys = [], []
    x, y = x1, y1
    for _ in range(major + 1):
        xs.append(x)
        ys.append(y)
        step_minor = err < 0
        err += -2 * minor + (2 * major if step_minor else 0)
        if vert:
            y += sy
            x += 1 if step_minor else 0
        else:
            x += 1
            y += sy if step_minor else 0
    return xs, ys


def draw_bbox_3d(img: np.ndarray, corners_2d: np.ndarray,
                 color=(255, 0, 0), thickness: int = 1) -> np.ndarray:
    """Wireframe of a projected 3-D box from its 8 corners (ordered as
    :func:`box_corners` gives them): two closed polylines, 8-connected,
    one pixel thick."""
    if thickness != 1:
        raise ValueError(f"draw_bbox_3d: thickness {thickness}; only 1 "
                         "is drawn")
    img = np.ascontiguousarray(img).copy()
    h, w = img.shape[:2]
    c = np.asarray(corners_2d, np.int32)
    col = np.asarray([int(v) for v in color][:img.shape[2]], img.dtype)
    for loop in ([0, 1, 3, 2, 0, 4, 6, 2], [5, 4, 6, 7, 5, 1, 3, 7]):
        pts = c[loop]
        for i in range(len(pts)):           # closed: last -> first first
            xs, ys = _line_pixels(w, h, pts[i - 1], pts[i])
            img[ys, xs] = col
    return img


def box_corners(pts: np.ndarray) -> np.ndarray:
    """[8, 3] axis-aligned bounding-box corners of a model point cloud,
    ordered for :func:`draw_bbox_3d`."""
    lo, hi = np.min(pts, 0), np.max(pts, 0)
    return np.array([[x, y, z]
                     for x in (lo[0], hi[0])
                     for y in (lo[1], hi[1])
                     for z in (lo[2], hi[2])], np.float32)


def draw_pose(img: np.ndarray, model_pts: np.ndarray, R: np.ndarray,
              t: np.ndarray, K: np.ndarray, color=(0, 255, 0),
              r: int = 1, bbox: bool = True) -> np.ndarray:
    """Overlay a model under pose (R, t): ``model_pts @ R.T + t``
    (metres, camera frame) projected through K and pasted in ``color``,
    with the 3-D bounding-box wireframe unless ``bbox`` is False."""
    cam = np.asarray(model_pts, np.float64) @ np.asarray(R, np.float64).T \
        + np.asarray(t, np.float64)
    img = paste_points(img, project_p3d(cam, K), color)
    if bbox:
        corners = box_corners(model_pts) @ np.asarray(R, np.float64).T \
            + np.asarray(t, np.float64)
        img = draw_bbox_3d(img, project_p3d(corners, K), color)
    return img
