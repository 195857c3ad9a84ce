"""Shared device and argument policy of the port's kernels.

``resolve_device`` is how every entry point picks its device: ``cuda``
unless the caller names one, and an error when no GPU is present and the
caller named none (the port never carries on quietly on the CPU).  The
``ops`` modules dispatch on the device of the tensors they are given: a
CPU tensor goes to the plain PyTorch twin, a CUDA tensor to the
hand-written kernel, anything else raises.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means the GPU, which must
    exist."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch versions of the kernels on the host")
        return torch.device("cuda")
    return torch.device(device)


def is_cpu(t: torch.Tensor) -> bool:
    """True for a CPU tensor (plain twin), False for a CUDA tensor
    (kernel); raises for any other device."""
    if t.device.type == "cpu":
        return True
    if t.device.type == "cuda":
        return False
    raise ValueError(f"unsupported device {t.device} (cpu or cuda)")


def check_cuda_arg(name: str, t: torch.Tensor, dtype: torch.dtype,
                   shape: Optional[Sequence[int]] = None,
                   device: Optional[torch.device] = None) -> None:
    """Validate one kernel argument before its pointer is passed on."""
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor (got {t.device})")
    if device is not None and t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype} (got {t.dtype})")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)} "
                         f"(got {tuple(t.shape)})")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
