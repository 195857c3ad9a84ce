"""Public op: int8 update compression, the wire format of
``EnFedConfig.compress="int8"`` (port of ``repro.kernels.quantize.ops``).

A flattened fp32 update travels as tile-padded int8 codes plus one fp32
scale per 1024-element tile.  The loop engine packs each contributor's
update with :func:`compress_update` and unpacks it with
:func:`decompress_update`; the fleet engine carries its (R, N, P) round
state in that format, requantizes refreshed rows with
:func:`quantize_flat_batched` and aggregates it with the fused q8 eq. 14.
:func:`compressed_nbytes` is the byte count the cost model prices.

A CPU tensor runs the plain twin (``ref.py``); a CUDA tensor launches the
hand-written kernel (``kernel.py``) or raises.  ``dequantize_flat_batched``
is plain torch on every device, as the JAX package leaves it to XLA.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.common import is_cpu
from repro_torch.kernels.quantize.kernel import dequantize_cuda, quantize_cuda
from repro_torch.kernels.quantize.ref import (TILE, dequantize_batched_ref,
                                              dequantize_ref, quantize_batched_ref)

# ``compress="auto"`` picks int8 only when the tile-padded image is at most
# this share of the raw fp32 bytes; below the crossover (small models, where
# the padding dominates) it stays fp32.
AUTO_COMPRESS_MAX_RATIO = 0.5


def padded_len(orig_len: int) -> int:
    """Wire-format payload length: ``orig_len`` padded up to TILE."""
    return orig_len + (-orig_len) % TILE


def compressed_nbytes(num_params: int) -> int:
    """Bytes of one int8-compressed update on the wire: padded int8
    payload + one fp32 scale per tile (AES-CTR keeps the length)."""
    lp = padded_len(num_params)
    return lp + 4 * (lp // TILE)


def resolve_compress(mode, num_params: int) -> Optional[str]:
    """``None`` and ``"int8"`` pass through; ``"auto"`` is ``"int8"`` iff
    the int8 image is at most ``AUTO_COMPRESS_MAX_RATIO`` of the fp32
    bytes of a ``num_params`` update, else ``None``."""
    if mode is None or mode == "int8":
        return mode
    if mode == "auto":
        if compressed_nbytes(num_params) <= AUTO_COMPRESS_MAX_RATIO * 4 * num_params:
            return "int8"
        return None
    raise ValueError(f"unknown compress mode {mode!r}; one of None, 'int8', 'auto'")


def quantize_flat_batched(x: torch.Tensor):
    """x (B, L) or (L,) fp32 -> (q int8 (B, Lp), scales fp32 (B, Lp / TILE)),
    without B for one row.  A
    row whose length is not a multiple of TILE quantizes as if padded with
    zeros, which is what the reference's callers pad it with."""
    if is_cpu(x):
        return quantize_batched_ref(x)
    return quantize_cuda(x.contiguous())


def dequantize_flat_batched(q: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """Elementwise ``q * scale`` over (..., Lp) wire-format rows."""
    return dequantize_batched_ref(q, scales)


def compress_update(vec: torch.Tensor):
    """vec (L,) fp32 -> (q (Lp,) int8, scales (Lp / TILE,) fp32, L)."""
    q, s = quantize_flat_batched(vec)
    return q, s, int(vec.shape[0])


def decompress_update(q: torch.Tensor, scales: torch.Tensor, orig_len: int) -> torch.Tensor:
    """The inverse of :func:`compress_update`: (orig_len,) fp32."""
    if is_cpu(q):
        return dequantize_ref(q, scales, orig_len)
    return dequantize_cuda(q.contiguous(), scales.contiguous(), orig_len)
