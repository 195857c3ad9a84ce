"""Threefry-2x32 counter-based random bits, bit-exact with ``jax.random``.

The JAX package derives its minibatch schedule (``core/schedule.py``) and
its Byzantine world (``core/adversary.py``) from ``jax.random``:
``PRNGKey`` -> ``fold_in`` -> ``bits`` / ``randint`` / ``normal``.  This
module reproduces those calls bit for bit on int64 tensors masked to 32
bits, so the port draws the same batches and the same attacks from the
same seed.

``jax_threefry_partitionable`` changes how a key turns into bits.  With
the flag True (the default of jax 0.9) element ``i`` of a draw hashes the
counter pair ``(i >> 32, i & 0xFFFFFFFF)`` and returns ``y0 ^ y1``, and
``split`` hashes ``(0, i)`` into key ``i``.  With it False a draw of ``n``
words hashes the pairs ``(i, i + n/2)`` of the padded iota and
concatenates the two output halves, and ``split`` is such a draw of
``2 * num`` words.  ``PRNGKey`` and ``fold_in`` are the same under both.
Every function that draws bits takes ``partitionable`` explicitly.

Keys are int64 tensors of shape ``(..., 2)`` holding uint32 words; every
function below takes a batch of keys and draws for each.  ``normal`` goes
through ``torch.erfinv``, which may differ from XLA's by an ulp; every
integer draw and the ``uniform`` bits are exact.
"""

from __future__ import annotations

import math

import numpy as np
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


def _iota_pairs(size: int, partitionable: bool, device):
    """The counter pairs a draw of ``size`` words hashes, and how to read
    its words back: ``(x0, x1, combine)``."""
    if partitionable:
        i = torch.arange(size, dtype=torch.int64, device=device)
        return i >> 32, i & _MASK, lambda y0, y1: y0 ^ y1
    half = (size + 1) // 2
    i = torch.arange(2 * half, dtype=torch.int64, device=device)
    i[size:] = 0                      # an odd count pads with a zero counter
    return i[:half], i[half:], lambda y0, y1: torch.cat([y0, y1], dim=-1)[..., :size]


def random_bits(key: torch.Tensor, shape=(), *, partitionable: bool = True):
    """``jax.random.bits(key, shape, jnp.uint32)`` for a batch of keys
    ``(..., 2)``: uint32 words (in int64) of shape ``(..., *shape)``."""
    shape = tuple(int(d) for d in shape)
    size = math.prod(shape)
    x0, x1, combine = _iota_pairs(size, partitionable, key.device)
    y0, y1 = threefry2x32(key[..., 0:1], key[..., 1:2], x0, x1)
    return combine(y0, y1).reshape(key.shape[:-1] + shape)


def split(key: torch.Tensor, num: int = 2, *, partitionable: bool = True):
    """``jax.random.split(key, num)`` for a batch of keys ``(..., 2)``:
    keys of shape ``(..., num, 2)``."""
    if partitionable:
        i = torch.arange(num, dtype=torch.int64, device=key.device)
        y0, y1 = threefry2x32(key[..., 0:1], key[..., 1:2], torch.zeros_like(i), i)
        return torch.stack([y0, y1], dim=-1)
    words = random_bits(key, (2 * num,), partitionable=False)
    return words.reshape(key.shape[:-1] + (num, 2))


def randint(key: torch.Tensor, shape, minval: int, maxval: int, *,
            partitionable: bool = True) -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval, jnp.int32)`` for a
    batch of keys ``(..., 2)``: int32 values (in int64) in
    ``[minval, maxval)``, shape ``(..., *shape)``.

    As jax does: two words per value from the two halves of a split key,
    folded as ``(hi % span * (2**32 % span) + lo % span) % span`` in
    wrapping uint32 arithmetic, where ``2**32 % span`` is computed as
    ``(2**16 % span)**2 % 2**32 % span``."""
    i32_min, i32_max = -(1 << 31), (1 << 31) - 1
    out_of_range = maxval > i32_max
    lo_v = min(max(int(minval), i32_min), i32_max)
    hi_v = min(max(int(maxval), i32_min), i32_max)
    span = (hi_v - lo_v) & _MASK
    if hi_v <= lo_v:
        span = 1
    elif out_of_range:
        span = (span + 1) & _MASK
    k = split(key, 2, partitionable=partitionable)
    higher = random_bits(k[..., 0, :], shape, partitionable=partitionable)
    lower = random_bits(k[..., 1, :], shape, partitionable=partitionable)
    if span == 0:                     # the full 2**32 range: the remainders vanish
        offset = ((higher * 0) + lower) & _MASK
    else:
        mult = (((1 << 16) % span) ** 2 & _MASK) % span
        offset = (((higher % span) * mult & _MASK) + lower % span) & _MASK
        offset = offset % span
    v = (lo_v + offset) & _MASK
    return torch.where(v >= (1 << 31), v - (1 << 32), v)


def uniform(key: torch.Tensor, shape=(), minval: float = 0.0, maxval: float = 1.0, *,
            partitionable: bool = True) -> torch.Tensor:
    """``jax.random.uniform(key, shape, jnp.float32, minval, maxval)`` for
    a batch of keys ``(..., 2)``: the top 23 bits of a word fill the
    mantissa of a float in [1, 2), minus 1, scaled and shifted in fp32."""
    words = random_bits(key, shape, partitionable=partitionable)
    floats = ((words >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    lo = torch.tensor(minval, dtype=torch.float32, device=key.device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=key.device)
    return torch.maximum(lo, floats * (hi - lo) + lo)


_NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
_SQRT2 = float(np.float32(np.sqrt(2)))


def normal(key: torch.Tensor, shape=(), *, partitionable: bool = True) -> torch.Tensor:
    """``jax.random.normal(key, shape, jnp.float32)`` for a batch of keys
    ``(..., 2)``: ``sqrt(2) * erfinv(uniform(nextafter(-1, 0), 1))``."""
    u = uniform(key, shape, _NORMAL_LO, 1.0, partitionable=partitionable)
    return _SQRT2 * torch.erfinv(u)
