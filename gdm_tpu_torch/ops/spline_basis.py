"""Open B-spline basis (numpy, host) and dense spline convolution (torch).

Counterpart of gdm_tpu/ops/spline_basis.py.  ``spline_basis_np`` and
``cartesian_pseudo`` are numpy copies of the JAX package's host functions,
which cannot be imported without jax; the tests hold them bit-equal.

The mesh graph is a KNN-k graph, so every node has exactly k in-edges and
SplineConv (dim 3, kernel 5, degree 1, mean aggregation, root weight,
bias) becomes all slot projections in one batched product, a gather and a
basis-weighted sum:

    Y[s]   = X @ W[s]
    out[i] = mean_k sum_c b[i,k,c] * Y[slot[i,k,c], idx[i,k]] + X[i] @ W_root + bias
"""

from __future__ import annotations

import numpy as np
import torch


def spline_basis_np(pseudo: np.ndarray, kernel_size: int = 5, dim: int = 3):
    """Degree-1 open B-spline basis over [0, 1]^dim pseudo-coordinates.

    Returns (basis [..., 2**dim] f32, slot [..., 2**dim] int32), the
    torch_spline_conv slot convention."""
    pseudo = np.asarray(pseudo, np.float32)
    v = pseudo * (kernel_size - 1)
    bot = np.floor(v)
    frac = (v - bot).astype(np.float32)
    bot = bot.astype(np.int32) % kernel_size

    n_combo = 1 << dim
    basis = np.empty(pseudo.shape[:-1] + (n_combo,), np.float32)
    slot = np.empty(pseudo.shape[:-1] + (n_combo,), np.int32)
    for c in range(n_combo):
        b = np.ones(pseudo.shape[:-1], np.float32)
        s = np.zeros(pseudo.shape[:-1], np.int32)
        stride = 1
        for d in range(dim):
            bit = (c >> d) & 1
            f = frac[..., d]
            b = b * (f if bit else 1.0 - f)
            s = s + ((bot[..., d] + bit) % kernel_size) * stride
            stride *= kernel_size
        basis[..., c] = b
        slot[..., c] = s
    return basis, slot


def cartesian_pseudo(pos: np.ndarray, neigh_idx: np.ndarray) -> np.ndarray:
    """torch_geometric T.Cartesian(norm=True) pseudo-coordinates [n, k, 3]:
    (pos_j - pos_i) / (2 * max_abs) + 0.5 over all edges."""
    cart = pos[neigh_idx] - pos[:, None, :]
    max_abs = np.abs(cart).max()
    return cart / (2.0 * max_abs) + 0.5


def spline_conv_dense(x: torch.Tensor, neigh_idx: torch.Tensor,
                      basis: torch.Tensor, slot: torch.Tensor,
                      weight: torch.Tensor, root_weight: torch.Tensor,
                      bias: torch.Tensor) -> torch.Tensor:
    """Dense spline convolution over a fixed-degree KNN graph.

    Args:
      x: [n, c_in]; neigh_idx: [n, k] int64; basis, slot: [n, k, 2**dim]
      (slot int64); weight: [K**dim, c_in, c_out]; root_weight:
      [c_in, c_out]; bias: [c_out].
    Returns:
      [n, c_out], mean over the k in-edges.
    """
    n, k = neigh_idx.shape
    n_slots, _, c_out = weight.shape
    y = torch.matmul(x, weight).reshape(n_slots * n, c_out)   # [S*n, c_out]
    flat = slot * n + neigh_idx[..., None]                    # [n, k, C]
    g = y.index_select(0, flat.reshape(-1)).view(
        n, k, basis.shape[-1], c_out)
    msg = torch.sum(g * basis[..., None], dim=2)              # [n, k, c_out]
    return torch.mean(msg, dim=1) + x @ root_weight + bias
