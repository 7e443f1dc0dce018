"""JAX's counter-based PRNG, bit for bit, in torch.

RANSAC (ops/ransac.py) samples its hypotheses from a JAX key,
``fold_in(PRNGKey(0), sum(idx))`` (gdm_tpu/eval/pose_fit.py:153-154);
a ``torch.Generator`` would draw other hypotheses and fit other poses.
This module reproduces what ``jax.random`` computes under jax 0.9.0 with
its defaults ``jax_default_prng_impl=threefry2x32`` and
``jax_threefry_partitionable=True``:

* ``threefry2x32``: the Threefry-2x32 hash, 20 rounds (jax._src.prng);
* a key is two uint32 words; ``prng_key(seed)`` is (seed >> 32, seed &
  0xFFFFFFFF); ``fold_in(key, d)`` hashes the counter pair (0, d);
* random bits in the partitionable layout: element i of the flattened
  shape hashes the counter pair (i >> 32, i & 0xFFFFFFFF), and its 32
  bits are the two output words XORed;
* ``uniform``: the top 23 bits as the mantissa of a float in [1, 2),
  minus 1, scaled to [minval, maxval) and raised to minval;
* ``gumbel`` (mode "low"): -log(-log(u)), u uniform in [tiny, 1).

The bits and the uniforms are equal to JAX's.  ``torch.log`` may differ
from XLA's log in the last place, so a Gumbel sample may too.

The uint32 words are held in int64 tensors and masked to 32 bits after
every add and shift, on the device of the key.
"""

from __future__ import annotations

import torch

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & MASK


def threefry2x32(k0: torch.Tensor, k1: torch.Tensor, x0: torch.Tensor,
                 x1: torch.Tensor):
    """Threefry-2x32 of the counter words (x0, x1) under the key words
    (k0, k1); all int64 holding uint32 values, broadcast together.
    Returns the two output words."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & MASK
    x1 = (x1 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & MASK
    return x0, x1


def prng_key(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)``: [2] int64 words."""
    return torch.tensor([(seed >> 32) & MASK, seed & MASK],
                        dtype=torch.int64, device=device)


def fold_in(key: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """``jax.random.fold_in`` for a batch of data: key [2] or [..., 2],
    data [...] integers (taken as uint32) -> keys [..., 2]."""
    data = torch.as_tensor(data, device=key.device).to(torch.int64) & MASK
    o0, o1 = threefry2x32(key[..., 0], key[..., 1],
                          torch.zeros_like(data), data)
    return torch.stack([o0, o1], dim=-1)


def random_bits(key: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.bits(key, shape)`` (uint32) for each key of a batch:
    keys [..., 2] -> int64 [..., *shape] holding uint32 values."""
    size = 1
    for s in shape:
        size *= s
    i = torch.arange(size, dtype=torch.int64, device=key.device)
    b0, b1 = threefry2x32(key[..., 0, None], key[..., 1, None],
                          i >> 32, i & MASK)
    return (b0 ^ b1).reshape(*key.shape[:-1], *shape)


def uniform(key: torch.Tensor, shape, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32, minval, maxval)`` for
    each key of a batch: keys [..., 2] -> f32 [..., *shape]."""
    bits = random_bits(key, shape)
    one = (bits >> 9) | 0x3F800000                     # [1, 2) as bits
    floats = one.to(torch.int32).view(torch.float32) - 1.0
    lo = torch.tensor(minval, dtype=torch.float32, device=key.device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=key.device)
    return torch.maximum(lo, floats * (hi - lo) + lo)


def gumbel(key: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.gumbel(key, shape)`` (mode "low", float32) for each
    key of a batch: keys [..., 2] -> f32 [..., *shape]."""
    tiny = torch.finfo(torch.float32).tiny
    return -torch.log(-torch.log(uniform(key, shape, tiny, 1.0)))
