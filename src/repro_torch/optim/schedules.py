"""Learning-rate schedules, step -> lr (port of ``repro.optim.schedules``).

Each schedule takes the step as a tensor (or an int) and returns a 0-d
fp32 tensor on the step's device, computed in fp32 as the reference's
``jnp`` does."""

from __future__ import annotations

import math

import torch


def _f32(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def constant(value: float):
    return lambda step: torch.tensor(value, dtype=torch.float32,
                                     device=torch.as_tensor(step).device)


def cosine_decay(peak: float, total_steps: int, final_frac: float = 0.1):
    def f(step):
        t = torch.clamp_max(_f32(step) / total_steps, 1.0)
        cos = 0.5 * (1 + torch.cos(math.pi * t))
        return torch.tensor(peak, dtype=torch.float32, device=t.device) * (
            final_frac + (1 - final_frac) * cos)

    return f


def warmup_cosine(peak: float, warmup_steps: int, total_steps: int, final_frac: float = 0.1):
    def f(step):
        s = _f32(step)
        warm = s / max(warmup_steps, 1)
        t = torch.clamp((s - warmup_steps) / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = final_frac + (1 - final_frac) * 0.5 * (1 + torch.cos(math.pi * t))
        return torch.tensor(peak, dtype=torch.float32, device=s.device) * torch.where(
            s < warmup_steps, warm, cos)

    return f
