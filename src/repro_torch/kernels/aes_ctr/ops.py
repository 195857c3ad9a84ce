"""Public op: AES-128-CTR over a uint8 payload; decryption is the same
call.  A CPU tensor runs the plain twin; a CUDA tensor launches the
hand-written kernel or raises, unless the caller selected the twins
(``kernels.common.plain_twins``)."""

from __future__ import annotations

import torch

from repro_torch.kernels.aes_ctr.kernel import aes_ctr_cuda
from repro_torch.kernels.aes_ctr.ref import aes_ctr_ref
from repro_torch.kernels.common import costed, op_cost, use_twin

# the least lookups of AES-128 per 16-byte block, by 32-bit T-tables: 16
# words in each of the 9 full rounds, 16 S-box bytes in the last one
AES_LOOKUPS_PER_BLOCK = 9 * 16 + 16


def aes_ctr_cost(n: int) -> dict:
    """AES-128-CTR over ``n`` bytes: the payload read and written once,
    the tables (3 x 256), round keys (11 x 16) and nonce read once.  Its
    operations are its table lookups, counted under ``flops`` (they are
    read at the card's shared-memory rate, not its fp32 rate)."""
    blocks = (n + 15) // 16
    return op_cost(flops=blocks * AES_LOOKUPS_PER_BLOCK,
                   bytes_accessed=2 * n + 3 * 256 + 11 * 16 + 8, launches=int(n > 0))


@costed("aes_ctr", lambda payload, round_keys, nonce, tables: aes_ctr_cost(payload.numel()))
def aes_ctr(payload: torch.Tensor, round_keys: torch.Tensor,
            nonce: torch.Tensor, tables: torch.Tensor) -> torch.Tensor:
    if use_twin(payload):
        return aes_ctr_ref(payload, round_keys, nonce, tables)
    return aes_ctr_cuda(payload, round_keys, nonce, tables)
