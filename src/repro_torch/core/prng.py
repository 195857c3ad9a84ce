"""Threefry-2x32 counter-based random bits, bit-exact with ``jax.random``.

The JAX package derives its minibatch schedule from ``jax.random``
(``PRNGKey`` -> ``fold_in`` -> ``bits``, see ``core/schedule.py``).  This
module reproduces those three calls bit for bit on int64 tensors masked to
32 bits, so the port draws the same batches from the same seed.

``jax_threefry_partitionable`` changes what ``bits`` returns for one
key: with the flag True (the default of jax 0.9) a scalar draw hashes the
counter pair ``(0, 0)`` and returns ``y0 ^ y1``; with it False it hashes
``(0, 0)`` and returns ``y0`` alone.  ``PRNGKey`` and ``fold_in`` are the
same under both.  Every function that draws bits takes ``partitionable``
explicitly.

Keys are int64 tensors of shape ``(..., 2)`` holding uint32 words.
"""

from __future__ import annotations

import torch

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(v: torch.Tensor, r: int) -> torch.Tensor:
    return ((v << r) | (v >> (32 - r))) & _MASK


def threefry2x32(k0: torch.Tensor, k1: torch.Tensor, x0: torch.Tensor,
                 x1: torch.Tensor):
    """The Threefry-2x32 block (20 rounds) on broadcastable int64 tensors
    of uint32 words.  Returns the two output words."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x0, x1


def prng_key(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` for a 32-bit seed: the words
    ``(seed >> 32, seed & 0xFFFFFFFF)``, i.e. ``(0, seed)``."""
    seed = int(seed)
    if not -(1 << 31) <= seed < (1 << 31):
        raise ValueError(f"seed must fit in int32 (got {seed})")
    return torch.tensor([0, seed & _MASK], dtype=torch.int64, device=device)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``: hash the counter pair ``(0, data)`` under
    ``key``.  ``data`` (int or int64 tensor of uint32 values) broadcasts
    against the key's leading shape; returns keys of shape ``(..., 2)``."""
    data = torch.as_tensor(data, dtype=torch.int64, device=key.device) & _MASK
    y0, y1 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(data),
                          data)
    return torch.stack([y0, y1], dim=-1)


def bits(key: torch.Tensor, *, partitionable: bool = True) -> torch.Tensor:
    """``jax.random.bits(key, (), jnp.uint32)`` for a batch of keys
    ``(..., 2)``: one uint32 (in int64) per key."""
    zero = torch.zeros_like(key[..., 0])
    y0, y1 = threefry2x32(key[..., 0], key[..., 1], zero, zero)
    return y0 ^ y1 if partitionable else y0
