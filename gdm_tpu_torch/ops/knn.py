"""Exact k-nearest-neighbour search (batched, brute force).

Counterpart of gdm_tpu/ops/knn.py in its exact mode.  Distances are
|a|^2 - 2ab + |b|^2 in f32, clamped at 0; queries run in chunks so peak
memory is B * chunk * n floats.  Neighbours come in ascending distance
with ties to the lowest index: the first k of a *stable* ascending sort
(``torch.topk`` does not promise that order).  With fewer support points
than k, the last neighbour repeats.
"""

from __future__ import annotations

import torch


def pairwise_sqdist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[B, n, d] x [B, m, d] -> [B, n, m] squared distances."""
    a = a.to(torch.float32)
    b = b.to(torch.float32)
    a2 = torch.sum(a * a, dim=-1, keepdim=True)            # [B, n, 1]
    b2 = torch.sum(b * b, dim=-1, keepdim=True).transpose(1, 2)
    ab = torch.bmm(a, b.transpose(1, 2))
    return torch.clamp_min(a2 - 2.0 * ab + b2, 0.0)


def topk_block(sqd: torch.Tensor, k: int) -> torch.Tensor:
    """Indices [..., k] int64 of the k smallest entries of each row of
    ``sqd`` [..., n], ascending, ties to the lowest index."""
    n = sqd.shape[-1]
    k_eff = min(k, n)
    if k_eff == 1:
        idx = torch.argmin(sqd, dim=-1, keepdim=True)
    else:
        idx = torch.sort(sqd, dim=-1, stable=True).indices[..., :k_eff]
    if k_eff < k:
        idx = torch.cat([idx, idx[..., -1:].expand(
            idx.shape[:-1] + (k - k_eff,))], dim=-1)
    return idx


def knn(support: torch.Tensor, query: torch.Tensor, k: int,
        chunk: int = 1024) -> torch.Tensor:
    """[B, n, 3] support, [B, m, 3] query -> [B, m, k] int64 indices."""
    return torch.cat([
        topk_block(pairwise_sqdist(query[:, s:s + chunk], support), k)
        for s in range(0, query.shape[1], chunk)], dim=1)


def argmin_prefixes(support: torch.Tensor, query: torch.Tensor, prefixes,
                    chunk: int = 1024):
    """Nearest-support index per query for several support prefixes at
    once: one distance block per query chunk, one argmin per prefix.

    Returns a tuple of [B, m, 1] int64, one per prefix, equal to separate
    ``knn(support[:, :p], query, 1)`` searches."""
    outs = [[] for _ in prefixes]
    for s in range(0, query.shape[1], chunk):
        d = pairwise_sqdist(query[:, s:s + chunk], support)
        for o, p in zip(outs, prefixes):
            o.append(torch.argmin(d[..., :p], dim=-1, keepdim=True))
    return tuple(torch.cat(o, dim=1) for o in outs)


def knn_with_dist(support: torch.Tensor, query: torch.Tensor, k: int,
                  chunk: int = 512):
    """:func:`knn` that also returns the euclidean distances: [B, n, 3]
    support, [B, m, 3] query -> (indices [B, m, k] int64, distances
    [B, m, k] f32, the square roots of the clamped squared distances).
    k = 1 is an argmin, ties to the lowest index as in ``top_k``; with
    fewer support points than k, the last neighbour and its distance
    repeat."""
    idx, dist = [], []
    for s in range(0, query.shape[1], chunk):
        d = pairwise_sqdist(query[:, s:s + chunk], support)
        i = topk_block(d, k)
        idx.append(i)
        dist.append(torch.gather(d, -1, i))
    return torch.cat(idx, dim=1), torch.sqrt(torch.cat(dist, dim=1))
