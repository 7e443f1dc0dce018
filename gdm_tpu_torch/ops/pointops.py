"""Point-cloud primitive ops (pointops parity) on tensors.

Counterpart of gdm_tpu/ops/pointops.py: farthest point sampling,
gathering and grouping, ball and k-NN queries, inverse-distance 3-NN
interpolation, the label-histogram ops and the nearest-anchor
distribute / gather pair.  Each takes one cloud ([n, 3], as JAX's do) or
a batch of clouds with a leading axis ([B, n, 3], what the JAX tests get
with ``jax.vmap``), and runs on the device of its inputs.  Indices are
int64 (torch's index type; JAX's are int32); histograms are int32.

The queries' distances are the expanded form of
``ops/knn.pairwise_sqdist``, as JAX's, and farthest point sampling's the
direct (dx*dx + dy*dy) + dz*dz; neighbour order is ascending distance
with ties to the lowest index (a stable sort, as ``lax.top_k``).
``feature_gather``'s gradient is autograd's scatter-add through
``gather``, the VJP JAX derives for ``take``.
"""

from __future__ import annotations

import functools

import torch

from gdm_tpu_torch.ops.knn import knn, knn_with_dist, pairwise_sqdist, \
    topk_block
from gdm_tpu_torch.ops.render_depth import fma32


def _batched(fn):
    """Run ``fn`` on [B, ...] inputs; a call whose first argument has no
    batch axis ([n, 3] or [n, c]) gets one added and removed."""

    @functools.wraps(fn)
    def wrapper(first, *args, **kwargs):
        if first.dim() >= 3:
            return fn(first, *args, **kwargs)
        args = [a[None] if isinstance(a, torch.Tensor) else a for a in args]
        return fn(first[None], *args, **kwargs)[0]

    return wrapper


def _take(feats: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """[B, n, c] rows gathered at [B, ...] indices -> [B, ..., c]."""
    b, c = feats.shape[0], feats.shape[-1]
    flat = idx.reshape(b, -1, 1).expand(-1, -1, c)
    return torch.gather(feats, 1, flat).reshape(*idx.shape, c)


@_batched
def farthest_point_sample(xyz: torch.Tensor, m: int) -> torch.Tensor:
    """[m] indices of iterative farthest-point sampling from index 0;
    each step takes the first point of the largest distance to the
    samples so far (argmax ties to the lowest index)."""
    b, n, _ = xyz.shape
    mind = torch.full((b, n), float("inf"), dtype=torch.float32,
                      device=xyz.device)
    idx = torch.empty((b, m), dtype=torch.int64, device=xyz.device)
    last = torch.zeros((b, 1), dtype=torch.int64, device=xyz.device)
    xyz = xyz.to(torch.float32)
    for i in range(m):
        idx[:, i:i + 1] = last
        dx, dy, dz = (xyz - _take(xyz, last)).unbind(-1)
        d = (dx * dx + dy * dy) + dz * dz      # the same bits on any device
        mind = torch.minimum(mind, d)
        last = torch.argmax(mind, dim=1, keepdim=True)
    return idx


@_batched
def gather_points(feats: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """[n, c] features at [m] indices -> [m, c]."""
    return _take(feats, idx)


@_batched
def group_points(feats: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """[n, c] features grouped by [m, k] neighbour indices -> [m, k, c]."""
    return _take(feats, idx)


def _ball(xyz, centers, radius):
    d2 = pairwise_sqdist(centers, xyz)                     # [B, m, n]
    return d2, d2 <= radius * radius


@_batched
def ball_query(xyz: torch.Tensor, centers: torch.Tensor, radius: float,
               k: int) -> torch.Tensor:
    """[m, k] indices of up to k points within ``radius`` of each centre,
    nearest first; slots past the in-ball count repeat the nearest (a
    centre with no point in its ball gets the lowest index)."""
    d2, in_ball = _ball(xyz, centers, radius)
    ranked = torch.where(in_ball, d2, torch.full_like(d2, float("inf")))
    idx = topk_block(ranked, k)
    valid = torch.gather(in_ball, -1, idx)
    return torch.where(valid, idx, idx[..., :1])


def _dot3(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """f32 ``sum(x * y, -1)`` over 3 lanes as XLA's CPU backend fuses it:
    fma(x2, y2, fma(x1, y1, x0 * y0))."""
    return fma32(x[..., 2], y[..., 2],
                 fma32(x[..., 1], y[..., 1], x[..., 0] * y[..., 0]))


@_batched
def three_nn_interpolate(src_xyz: torch.Tensor, src_feats: torch.Tensor,
                         dst_xyz: torch.Tensor) -> torch.Tensor:
    """[m, c] features of ``dst_xyz`` [m, 3]: the three nearest source
    points' [n, c] features weighted by (1/d) / sum(1/d).

    The neighbours come from ``ops/knn``; their distances and the
    weighted sum are then formed as JAX's fused CPU program forms them
    (norms, dot and the 3-term sum as FMA chains, ``fma32``), because
    the expanded distance of near points cancels: a last-bit difference
    in ``|a|^2 - 2ab + |b|^2`` moved the weights ~1e-4."""
    idx, _ = knn_with_dist(src_xyz, dst_xyz, 3)
    q = dst_xyz.to(torch.float32)[..., None, :]            # [B, m, 1, 3]
    p = _take(src_xyz.to(torch.float32), idx)              # [B, m, 3, 3]
    d2 = (_dot3(q, q) - 2.0 * _dot3(q, p)) + _dot3(p, p)
    w = 1.0 / torch.clamp_min(torch.sqrt(torch.clamp_min(d2, 0.0)), 1e-8)
    w = w / torch.sum(w, dim=-1, keepdim=True)
    f = _take(src_feats, idx)                              # [B, m, 3, c]
    w = w[..., None]
    return fma32(f[..., 2, :], w[..., 2, :],
                 fma32(f[..., 1, :], w[..., 1, :],
                       f[..., 0, :] * w[..., 0, :]))


@_batched
def knn_query(xyz: torch.Tensor, centers: torch.Tensor,
              k: int) -> torch.Tensor:
    """[m, k] indices of each centre's k nearest points (``ops/knn``)."""
    return knn(xyz, centers, k)


@_batched
def labelstat_ballrange(xyz: torch.Tensor, centers: torch.Tensor,
                        label_stat: torch.Tensor,
                        radius: float) -> torch.Tensor:
    """[m, nclass] int32: the ``label_stat`` [n, nclass] rows summed over
    every point within ``radius`` of each centre (no cap), exactly (a
    float64 product of the in-ball mask and the counts)."""
    _, in_ball = _ball(xyz, centers, radius)
    out = torch.bmm(in_ball.to(torch.float64),
                    label_stat.to(torch.float64))
    return torch.round(out).to(torch.int32)


@_batched
def labelstat_idx(label_stat: torch.Tensor, idx: torch.Tensor
                  ) -> torch.Tensor:
    """[m, nclass] int32: the ``label_stat`` rows summed over each
    centre's [m, k] neighbour list."""
    return torch.sum(_take(label_stat.to(torch.int32), idx), dim=-2,
                     dtype=torch.int32)


def labelstat_and_ballquery(xyz: torch.Tensor, centers: torch.Tensor,
                            label_stat: torch.Tensor, radius: float,
                            k: int):
    """(the full-ball histogram of :func:`labelstat_ballrange`, the
    capped :func:`ball_query` indices)."""
    return (labelstat_ballrange(xyz, centers, label_stat, radius),
            ball_query(xyz, centers, radius, k))


@_batched
def feature_distribute(max_xyz: torch.Tensor,
                       xyz: torch.Tensor) -> torch.Tensor:
    """[m] index of the nearest of the [n, 3] anchors ``max_xyz`` for each
    of the [m, 3] points ``xyz`` (argmin ties to the lowest index)."""
    return torch.argmin(pairwise_sqdist(xyz, max_xyz), dim=-1)


@_batched
def feature_gather(max_feature: torch.Tensor,
                   distribute_idx: torch.Tensor) -> torch.Tensor:
    """[n, c] anchor features at the [m] distribute indices -> [m, c];
    differentiable, the gradient scatter-added into the anchor rows."""
    return _take(max_feature, distribute_idx)
