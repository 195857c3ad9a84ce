"""AES-128-CTR for model-update transport (port of ``repro.core.crypto``).

The S-box and the GF(2^8) x2/x3 tables are derived at import from field
arithmetic (inverse + affine map), and the key schedule runs on the host
in numpy: keys are protocol state.  The keystream XOR runs through
``repro_torch.kernels.aes_ctr.ops``, which is the hand-written kernel on
a CUDA tensor and the plain twin on a CPU tensor.  The counter block is
the 8-byte nonce followed by the block index as 8 big-endian bytes.  An
fp32 update travels as its little-endian bytes (``tensor.view(uint8)``,
the same bytes as ``bitcast_convert_type``).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.kernels.aes_ctr.ops import aes_ctr
from repro_torch.kernels.aes_ctr.ref import aes128_blocks_ref

# ---------------------------------------------------------------------------
# GF(2^8) tables (built at import, host-side)
# ---------------------------------------------------------------------------


def _gf_mul(a: int, b: int) -> int:
    p = 0
    for _ in range(8):
        if b & 1:
            p ^= a
        hi = a & 0x80
        a = (a << 1) & 0xFF
        if hi:
            a ^= 0x1B
        b >>= 1
    return p


def _build_sbox() -> np.ndarray:
    inv = np.zeros(256, np.uint8)
    for x in range(1, 256):
        for y in range(1, 256):
            if _gf_mul(x, y) == 1:
                inv[x] = y
                break
    sbox = np.zeros(256, np.uint8)
    for x in range(256):
        b = int(inv[x])
        s = 0
        for i in range(8):
            bit = ((b >> i) ^ (b >> ((i + 4) % 8)) ^ (b >> ((i + 5) % 8))
                   ^ (b >> ((i + 6) % 8)) ^ (b >> ((i + 7) % 8)) ^ (0x63 >> i)) & 1
            s |= bit << i
        sbox[x] = s
    return sbox


_SBOX = _build_sbox()
_MUL2 = np.array([_gf_mul(x, 2) for x in range(256)], np.uint8)
_MUL3 = np.array([_gf_mul(x, 3) for x in range(256)], np.uint8)
TABLES = np.stack([_SBOX, _MUL2, _MUL3])   # (3, 256): what the kernel stages

_RCON = np.array([0x01, 0x02, 0x04, 0x08, 0x10, 0x20, 0x40, 0x80, 0x1B, 0x36], np.uint8)


def expand_key(key: np.ndarray) -> np.ndarray:
    """AES-128 key schedule: (16,) uint8 -> (11, 16) uint8 round keys."""
    key = np.asarray(key, np.uint8)
    if key.shape != (16,):
        raise ValueError(f"AES-128 key must be 16 bytes (got {key.shape})")
    words = [key[i * 4:(i + 1) * 4].copy() for i in range(4)]
    for i in range(4, 44):
        temp = words[i - 1].copy()
        if i % 4 == 0:
            temp = np.roll(temp, -1)
            temp = _SBOX[temp]
            temp[0] ^= _RCON[i // 4 - 1]
        words.append(words[i - 4] ^ temp)
    return np.stack([np.concatenate(words[i * 4:(i + 1) * 4]) for i in range(11)])


@functools.lru_cache(maxsize=8)
def _device_tables(device: torch.device) -> torch.Tensor:
    return torch.from_numpy(TABLES).to(device)


@functools.lru_cache(maxsize=1024)
def _key_material(key: bytes, nonce: bytes, device: torch.device):
    """Round keys and nonce of one link, as tensors on ``device``."""
    rk = torch.from_numpy(expand_key(np.frombuffer(key, np.uint8))).to(device)
    nv = torch.from_numpy(np.frombuffer(nonce, np.uint8).copy()).to(device)
    return rk, nv


def aes128_encrypt_blocks(blocks: torch.Tensor, round_keys) -> torch.Tensor:
    """blocks (M, 16) uint8, round_keys (11, 16) uint8 -> (M, 16) uint8
    (plain PyTorch; the FIPS-197 check runs through here)."""
    rk = torch.as_tensor(np.asarray(round_keys, np.uint8), device=blocks.device)
    return aes128_blocks_ref(blocks, rk, _device_tables(blocks.device))


# ---------------------------------------------------------------------------
# CTR mode over arbitrary payloads
# ---------------------------------------------------------------------------


def encrypt_bytes(payload_u8: torch.Tensor, key, nonce) -> torch.Tensor:
    """CTR encryption: payload (n,) uint8 -> ciphertext (n,) uint8."""
    dev = payload_u8.device
    rk, nv = _key_material(np.asarray(key, np.uint8).tobytes(),
                           np.asarray(nonce, np.uint8).tobytes(), dev)
    return aes_ctr(payload_u8, rk, nv, _device_tables(dev))


decrypt_bytes = encrypt_bytes  # CTR is an involution given the same keystream


def float_vector_to_bytes(vec: torch.Tensor) -> torch.Tensor:
    """(n,) float32 -> (4n,) uint8, little-endian (serialization)."""
    return vec.to(torch.float32).contiguous().view(torch.uint8)


def bytes_to_float_vector(u8: torch.Tensor) -> torch.Tensor:
    return u8.contiguous().view(torch.float32)


def encrypt_update(vec: torch.Tensor, key, nonce) -> torch.Tensor:
    """Encrypt a flattened fp32 model update (the transport unit)."""
    return encrypt_bytes(float_vector_to_bytes(vec), key, nonce)


def decrypt_update(cipher_u8: torch.Tensor, key, nonce) -> torch.Tensor:
    return bytes_to_float_vector(decrypt_bytes(cipher_u8, key, nonce))
