"""Hidden-point-removal visibility (Katz spherical flip + convex hull).

Counterpart of gdm_tpu/ops/visibility.py (reference
utils/compute_visibility.py: sphericalFlip :25, convexHull :41,
VisiblePoints :128-134), host numpy with scipy's ConvexHull (qhull), as in
the original.  It runs only in GT generation, and the hull is data
dependent, so it stays on the host.  As in the JAX package: the hull's
vertices are filtered by index (the appended origin is not assumed to be
listed last), and the flip radius exponent defaults to 2.0 (the
reference's pi marks much of the self-occluded side visible at qhull's
precision; pass pi to reproduce it).
"""

from __future__ import annotations

import numpy as np
from scipy.spatial import ConvexHull


def spherical_flip(points: np.ndarray, center: np.ndarray,
                   radius_param: float) -> np.ndarray:
    """Katz et al. spherical flip of ``points`` around camera ``center``."""
    pts = points - center.reshape(1, 3)
    norm = np.linalg.norm(pts, axis=1, keepdims=True)
    radius = np.max(norm) * (10.0 ** radius_param)
    return pts + 2.0 * (radius - norm) * pts / np.maximum(norm, 1e-12)


def visible_points(points: np.ndarray, cam_center: np.ndarray,
                   radius_param: float = 2.0) -> np.ndarray:
    """Indices of the mesh vertices visible from the camera centre (the
    model-frame camera position, the inverse pose's translation)."""
    flipped = spherical_flip(points, np.asarray(cam_center).reshape(3),
                             radius_param)
    cloud = np.concatenate([flipped, np.zeros((1, 3))], axis=0)
    hull = ConvexHull(cloud)
    idx = np.unique(hull.vertices)
    return idx[idx < points.shape[0]]
