"""Plain PyTorch per-tile symmetric int8 quantization: the spec of
``csrc/quantize.cu``.

Per 1024-element tile: ``scale = max(absmax, 1e-12) / 127`` and
``q = clip(round_half_even(x / scale), -127, 127)``.

The JAX package runs this math compiled (``quantize_pallas`` and every
engine path are jitted), and XLA rewrites the division by the constant 127
into a multiply by its fp32 reciprocal; so the scale here is
``max(absmax, 1e-12) * fp32(1/127)``, which is bit-equal to the Pallas
kernels' (an exact division differs by one ulp on some tiles).  The codes
divide by the scale, as XLA keeps a division by a tensor, and
``torch.round`` is round-half-to-even like ``jnp.round``: codes and scales
are bit-equal to the JAX package's.
"""

from __future__ import annotations

import numpy as np
import torch

TILE = 1024
INV_127 = float(np.float32(1.0 / 127.0))   # the reciprocal XLA multiplies by


def quantize_batched_ref(x: torch.Tensor, tile: int = TILE):
    """x (..., L) fp32 -> (q int8 (..., Lp), scales fp32 (..., Lp / tile)),
    Lp = L rounded up to ``tile``; the padding quantizes as zeros.  One
    update is the case ``x`` (L,)."""
    pad = (-x.shape[-1]) % tile
    if pad:
        x = torch.nn.functional.pad(x, (0, pad))
    lead = x.shape[:-1]
    xt = x.reshape(lead + (-1, tile)).to(torch.float32)
    absmax = torch.amax(torch.abs(xt), dim=-1)
    scale = torch.clamp_min(absmax, 1e-12) * INV_127
    q = torch.clamp(torch.round(xt / scale[..., None]), -127, 127).to(torch.int8)
    return q.reshape(lead + (-1,)), scale


def dequantize_batched_ref(q: torch.Tensor, scales: torch.Tensor, tile: int = TILE):
    """``q * scale`` over (..., Lp) rows: the exact wire inverse."""
    lead = q.shape[:-1]
    qt = q.reshape(lead + (-1, tile)).to(torch.float32)
    return (qt * scales[..., None]).reshape(lead + (-1,))


def dequantize_ref(q: torch.Tensor, scales: torch.Tensor, orig_len: int,
                   tile: int = TILE):
    """(Lp,) int8, (Lp / tile,) fp32 -> (orig_len,) fp32."""
    return dequantize_batched_ref(q, scales, tile)[:orig_len]
