"""Public op: AES-128-CTR over a uint8 payload; decryption is the same
call.  A CPU tensor runs the plain twin; a CUDA tensor launches the
hand-written kernel or raises."""

from __future__ import annotations

import torch

from repro_torch.kernels.aes_ctr.kernel import aes_ctr_cuda
from repro_torch.kernels.aes_ctr.ref import aes_ctr_ref
from repro_torch.kernels.common import is_cpu


def aes_ctr(payload: torch.Tensor, round_keys: torch.Tensor,
            nonce: torch.Tensor, tables: torch.Tensor) -> torch.Tensor:
    if is_cpu(payload):
        return aes_ctr_ref(payload, round_keys, nonce, tables)
    return aes_ctr_cuda(payload, round_keys, nonce, tables)
