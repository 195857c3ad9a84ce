"""Plain PyTorch AES-128-CTR: the spec of ``csrc/aes_ctr.cu``.

The cipher works on (blocks, 16) uint8 states in the column-major layout
of FIPS-197 (byte i = row + 4*col), vectorized over blocks with table
lookups.  ``tables`` is (3, 256) uint8: the S-box and the GF(2^8) x2 and
x3 tables, built from the field arithmetic in ``repro_torch.core.crypto``.
"""

from __future__ import annotations

import torch

# ShiftRows: output byte (row r, col c) comes from input (row r, col (c + r) mod 4)
_SHIFT_ROWS = [r + 4 * ((c + r) % 4) for c in range(4) for r in range(4)]


def _lookup(table: torch.Tensor, state: torch.Tensor) -> torch.Tensor:
    return table[state.long()]


def _mix_columns(state: torch.Tensor, mul2, mul3) -> torch.Tensor:
    s = state.reshape(-1, 4, 4)   # (blocks, col, row)
    a0, a1, a2, a3 = s[:, :, 0], s[:, :, 1], s[:, :, 2], s[:, :, 3]
    b0 = _lookup(mul2, a0) ^ _lookup(mul3, a1) ^ a2 ^ a3
    b1 = a0 ^ _lookup(mul2, a1) ^ _lookup(mul3, a2) ^ a3
    b2 = a0 ^ a1 ^ _lookup(mul2, a2) ^ _lookup(mul3, a3)
    b3 = _lookup(mul3, a0) ^ a1 ^ a2 ^ _lookup(mul2, a3)
    return torch.stack([b0, b1, b2, b3], dim=-1).reshape(-1, 16)


def aes128_blocks_ref(blocks: torch.Tensor, round_keys: torch.Tensor,
                      tables: torch.Tensor) -> torch.Tensor:
    """blocks (M, 16) uint8, round_keys (11, 16) uint8 -> (M, 16) uint8."""
    sbox, mul2, mul3 = tables[0], tables[1], tables[2]
    shift = torch.tensor(_SHIFT_ROWS, device=blocks.device)
    state = blocks ^ round_keys[0]
    for rnd in range(1, 10):
        state = _lookup(sbox, state)[:, shift]
        state = _mix_columns(state, mul2, mul3) ^ round_keys[rnd]
    return _lookup(sbox, state)[:, shift] ^ round_keys[10]


def counter_blocks_ref(nonce: torch.Tensor, n_blocks: int) -> torch.Tensor:
    """(n_blocks, 16) uint8: the 8-byte nonce, then the block index as 8
    big-endian bytes."""
    ctr = torch.arange(n_blocks, dtype=torch.int64, device=nonce.device)
    shifts = torch.arange(56, -8, -8, device=nonce.device)
    ctr_bytes = ((ctr[:, None] >> shifts[None, :]) & 0xFF).to(torch.uint8)
    return torch.cat([nonce[None, :].expand(n_blocks, 8), ctr_bytes], dim=1)


def aes_ctr_ref(payload: torch.Tensor, round_keys: torch.Tensor,
                nonce: torch.Tensor, tables: torch.Tensor) -> torch.Tensor:
    """payload (n,) uint8 -> (n,) uint8, XORed with the CTR keystream."""
    n = payload.shape[0]
    n_blocks = (n + 15) // 16
    ks = aes128_blocks_ref(counter_blocks_ref(nonce, n_blocks), round_keys,
                           tables)
    return payload ^ ks.reshape(-1)[:n]
