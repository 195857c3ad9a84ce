"""Initializers shared by the port's models (``repro.models.layers``)."""

from __future__ import annotations

import math

import torch


def dense_init(generator: torch.Generator, fan_in: int, fan_out: int,
               dtype=torch.float32, scale: float = 1.0, device=None) -> torch.Tensor:
    """(fan_in, fan_out) normal weights of std ``scale / sqrt(fan_in)``,
    drawn from ``generator`` (on the CPU) and moved to ``device``."""
    std = scale / math.sqrt(fan_in)
    w = torch.randn((fan_in, fan_out), generator=generator, dtype=torch.float32) * std
    return w.to(device=device, dtype=dtype)
