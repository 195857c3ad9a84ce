"""Byzantine-contributor world: per-round, per-link payload corruption,
shared by both engines (port of ``repro.core.adversary``).

Whether a delivered payload is corrupted, and for the noise attack what
the garbage is, is a closed-form function of ``(seed, round, requester,
contributor)``: counter-based ``fold_in`` chains of
:mod:`repro_torch.core.prng`, bit-exact with the JAX package's
``jax.random`` draws.  The loop engine and the fleet engine therefore
derive the same attacks, and any round's corruption set can be queried
without replaying earlier rounds.

Four attacks, applied to the WIRE image at the transport point (the loop
engine corrupts inside ``_collect_update``, before AES; the fleet engine
corrupts its delivered ``(R, N, .)`` buffer in the round body):

* ``signflip``: the payload is negated.  On the int8 wire the codes
  negate exactly (they live in [-127, 127]) and the scales pass through.
* ``scale``: the payload is multiplied by ``scale``.  On the int8 wire
  only the per-tile scales multiply.
* ``noise``: the payload is replaced by counter-keyed garbage of magnitude
  ``scale``: ``scale * N(0, 1)`` per coordinate on the dense wire, uniform
  codes in [-127, 127] with the constant tile scale ``scale / 127`` on the
  int8 wire.
* ``zero``: the payload (codes and scales) is zeroed.

Corruption never modifies the contributor's resident image, only the copy
aggregated this round.  The corruption predicate is an exact integer
comparison (``draw < int(p * (2**31 - 1))``), so no float rounding can
flip an outcome between engines.  Every draw takes the threefry mode
(``partitionable``) explicitly; the engines pass their task's.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import prng

# Corruption draws live in [0, _DRAW_MAX); a probability p maps to the
# threshold int(p * _DRAW_MAX).
_DRAW_MAX = 2**31 - 1

_SALT_BYZ = 0xB7    # per-(round, link) corruption predicate
_SALT_NOISE = 0xA6  # per-(round, link) noise payload

ATTACKS = ("signflip", "scale", "noise", "zero")


@dataclasses.dataclass(frozen=True)
class AdversaryConfig:
    """Byzantine-contributor world parameters for one simulated session.

    ``requester_id`` is the requesting device's id in the adversary
    hash-space; fleet lanes use ``requester_id + lane`` so concurrent
    requesters see independent corruption weather.  The default offset
    keeps it clear of contributor ids and of the other worlds' id spaces.
    """

    p_byzantine: float = 0.0   # per-(round, link) corruption probability
    attack: str = "signflip"   # one of ATTACKS
    scale: float = 10.0        # magnitude knob for "scale" / "noise"
    seed: int = 0              # adversary hash seed
    requester_id: int = 1 << 23  # requester lane 0's id in adversary space

    def __post_init__(self):
        if not 0.0 <= self.p_byzantine <= 1.0:
            raise ValueError(
                f"p_byzantine must be within [0, 1] (got {self.p_byzantine})")
        if self.attack not in ATTACKS:
            raise ValueError(
                f"attack must be one of {ATTACKS} (got {self.attack!r})")
        if self.scale <= 0.0:
            raise ValueError(f"scale must be > 0 (got {self.scale})")


def _f32(x: float) -> float:
    """``x`` rounded to fp32, as a Python float (a tensor times it
    multiplies by exactly that fp32 value)."""
    return float(np.float32(x))


def _threshold(p: float) -> int:
    """The integer threshold a probability compiles to."""
    return int(min(max(float(p), 0.0), 1.0) * _DRAW_MAX)


def _link_keys(seed: int, salt: int, r, requester_id, cand_id, device=None):
    """Keys ``(..., 2)`` of the chain ``PRNGKey(seed) -> fold_in(salt) ->
    round -> requester -> contributor``; ``requester_id`` and ``cand_id``
    (ints or int64 tensors) broadcast against each other."""
    key = prng.fold_in(prng.prng_key(seed, device=device), salt)
    key = prng.fold_in(key, int(r))
    req = torch.as_tensor(requester_id, dtype=torch.int64, device=device)
    cand = torch.as_tensor(cand_id, dtype=torch.int64, device=device)
    req, cand = torch.broadcast_tensors(req, cand)
    return prng.fold_in(prng.fold_in(key, req), cand)


def _link_draw(seed: int, salt: int, r, requester_id, cand_id, *,
               partitionable: bool = True, device=None) -> torch.Tensor:
    """Int32 draws (in int64) in [0, _DRAW_MAX), one per link."""
    keys = _link_keys(seed, salt, r, requester_id, cand_id, device)
    return prng.randint(keys, (), 0, _DRAW_MAX, partitionable=partitionable)


def corruption_mask(ac: AdversaryConfig, r, requester_id, cand_ids, *,
                    partitionable: bool = True) -> torch.Tensor:
    """Bool (..., N): which delivered payloads are corrupted at round
    ``r``.  ``requester_id`` is an int or an (R,) tensor, ``cand_ids``
    (N,) or (R, N); the result lies on ``cand_ids``' device.  ``r`` is the
    DELIVERING round.  Whether a link counts is the caller's mask."""
    ids = torch.as_tensor(cand_ids, dtype=torch.int64)
    req = torch.as_tensor(requester_id, dtype=torch.int64, device=ids.device)
    if req.dim():
        req = req[..., None]
    draws = _link_draw(ac.seed, _SALT_BYZ, r, req, ids,
                       partitionable=partitionable, device=ids.device)
    return draws < _threshold(ac.p_byzantine)


def noise_vector(ac: AdversaryConfig, r, requester_id, cand_id, length: int, *,
                 partitionable: bool = True, device=None) -> torch.Tensor:
    """(..., length) fp32 garbage of the noise attack (dense wire), one
    row per link: ``scale * N(0, 1)``, counter-keyed."""
    keys = _link_keys(ac.seed, _SALT_NOISE, r, requester_id, cand_id, device)
    return _f32(ac.scale) * prng.normal(keys, (int(length),), partitionable=partitionable)


def noise_codes(ac: AdversaryConfig, r, requester_id, cand_id, length: int, *,
                partitionable: bool = True, device=None) -> torch.Tensor:
    """(..., length) int8 garbage codes of the noise attack (int8 wire),
    one row per link: uniform in [-127, 127], counter-keyed."""
    keys = _link_keys(ac.seed, _SALT_NOISE, r, requester_id, cand_id, device)
    return prng.randint(keys, (int(length),), -127, 128,
                        partitionable=partitionable).to(torch.int8)


def noise_scale(ac: AdversaryConfig) -> float:
    """The constant per-tile scale of int8 noise payloads (fp32 value)."""
    return _f32(float(ac.scale) / 127.0)


def corrupt_dense(ac: AdversaryConfig, u: torch.Tensor, corrupt: bool, r,
                  requester_id, cand_id, *, partitionable: bool = True) -> torch.Tensor:
    """The payload the requester receives for ONE dense update ``u``
    (L,) fp32 when ``corrupt``; ``u`` itself otherwise.  The one-link case
    of :func:`corrupt_dense_batched`."""
    if not corrupt:
        return u
    one = torch.ones((1, 1), dtype=torch.bool, device=u.device)
    return corrupt_dense_batched(ac, u[None, None], one, r, [requester_id], [[cand_id]],
                                 partitionable=partitionable)[0, 0]


def corrupt_wire(ac: AdversaryConfig, q: torch.Tensor, scales: torch.Tensor,
                 corrupt: bool, r, requester_id, cand_id, *,
                 partitionable: bool = True):
    """``(q', scales')`` for ONE int8 wire payload: ``q`` (Lp,) codes,
    ``scales`` (Lp / 1024,) fp32.  The one-link case of
    :func:`corrupt_wire_batched`."""
    if not corrupt:
        return q, scales
    one = torch.ones((1, 1), dtype=torch.bool, device=q.device)
    bad_q, bad_s = corrupt_wire_batched(ac, q[None, None], scales[None, None], one, r,
                                        [requester_id], [[cand_id]],
                                        partitionable=partitionable)
    return bad_q[0, 0], bad_s[0, 0]


def _lane_ids(requester_ids, cand_ids, like: torch.Tensor):
    """(R, 1) requester and (R, N) contributor ids on ``like``'s device."""
    req = torch.as_tensor(requester_ids, dtype=torch.int64, device=like.device)
    ids = torch.as_tensor(cand_ids, dtype=torch.int64, device=like.device)
    return req[:, None], ids.expand(like.shape[:2])


def corrupt_dense_batched(ac: AdversaryConfig, u: torch.Tensor, corrupt: torch.Tensor,
                          r, requester_ids, cand_ids, *,
                          partitionable: bool = True) -> torch.Tensor:
    """The configured attack on every link of a dense (R, N, L) fp32
    delivered buffer ``u`` where ``corrupt`` (R, N) is set: the fleet's
    whole round, or one loop-engine link.  ``requester_ids`` (R,),
    ``cand_ids`` (N,) or (R, N); each noise row is keyed on its own link.
    Returns a new buffer; ``u`` is not modified."""
    if ac.attack == "noise":
        req, ids = _lane_ids(requester_ids, cand_ids, u)
        bad = noise_vector(ac, r, req, ids, u.shape[-1], partitionable=partitionable,
                           device=u.device)
    elif ac.attack == "signflip":
        bad = -u
    elif ac.attack == "scale":
        bad = _f32(ac.scale) * u
    else:
        bad = torch.zeros_like(u)
    return torch.where(corrupt[..., None], bad, u)


def corrupt_wire_batched(ac: AdversaryConfig, q: torch.Tensor, scales: torch.Tensor,
                         corrupt: torch.Tensor, r, requester_ids, cand_ids, *,
                         partitionable: bool = True):
    """The configured attack on every link of an int8 (R, N, Lp) wire
    buffer where ``corrupt`` (R, N) is set: codes ``q`` and scales
    (R, N, Lp / 1024) fp32, never a densified vector.  Returns new
    ``(q', scales')``; the inputs are not modified."""
    if ac.attack == "noise":
        req, ids = _lane_ids(requester_ids, cand_ids, q)
        bad_q = noise_codes(ac, r, req, ids, q.shape[-1], partitionable=partitionable,
                            device=q.device)
        bad_s = torch.full_like(scales, noise_scale(ac))
    elif ac.attack == "signflip":
        bad_q, bad_s = -q, scales
    elif ac.attack == "scale":
        bad_q, bad_s = q, _f32(ac.scale) * scales
    else:
        bad_q, bad_s = torch.zeros_like(q), torch.zeros_like(scales)
    sel = corrupt[..., None]
    return torch.where(sel, bad_q, q), torch.where(sel, bad_s, scales)
