"""Unreliable-link world: per-round, per-link drops, bounded retries and
stale delivery, shared by both engines (port of ``repro.core.faults``).

Every outcome is a closed-form function of ``(seed, round, requester,
contributor, attempt)``: counter-based ``fold_in`` chains of
:mod:`repro_torch.core.prng`, bit-exact with the JAX package's
``jax.random`` draws.  The loop engine (on the host, round by round) and
the fleet engine (on its device, every round of a run in one batch of
draws, ``r`` a tensor of rounds) therefore derive the same link weather,
and any round's faults can be queried without replaying the earlier ones.

Three failure modes per (requester, contributor) link and round:

* **Drop**: a transmission attempt fails when its int32 draw lands under
  the ``p_drop`` threshold.
* **Bounded retry**: up to ``max_retries`` retransmissions follow a failed
  attempt; the update is delivered when any of the ``max_retries + 1``
  attempts succeeds, and every attempt is priced through
  :meth:`repro_torch.core.energy.CostModel.retry_energy`.
* **Stale delivery**: a delivered update may be the contributor's
  round-(r-1) wire image instead of the current one.

A link whose previous ``release_after`` rounds all failed is *blocked*
(:func:`blocked_mask`): released at RENEGOTIATE under mobility, suspended
for the round in a static world.  Rounds before 0 count as delivered, so a
session starts with no fault history.

Every predicate is an exact integer comparison against a threshold
computed on the host in float64 (``int(p * (2**31 - 1))``), so no float
rounding can flip an outcome between engines.  Ids fold in as their low 32
bits (the reference's int32 -> uint32 cast), a negative round wraps as the
reference's uint32 conversion does, and every draw takes the threefry mode
(``partitionable``) explicitly.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import prng

# Fault draws live in [0, _DRAW_MAX); a probability p maps to the
# threshold int(p * _DRAW_MAX), so p=0 never fires and p=1 always does.
_DRAW_MAX = 2**31 - 1

_SALT_DROP = 0x0D
_SALT_STALE = 0x57


@dataclasses.dataclass(frozen=True)
class FaultConfig:
    """Unreliable-link world parameters for one simulated session.

    ``requester_id`` is the requesting device's id in the fault
    hash-space; fleet lanes use ``requester_id + lane`` so concurrent
    requesters see independent link weather.  The default offset keeps it
    clear of contributor ids and of the other worlds' id spaces.
    """

    p_drop: float = 0.0        # per-ATTEMPT transmission failure probability
    p_stale: float = 0.0       # P(delivered update is the round-(r-1) image)
    max_retries: int = 2       # bounded retransmissions after the first attempt
    release_after: int = 0     # consecutive fully-failed rounds before the
                               # link is released (0 = never)
    seed: int = 0              # fault hash seed
    requester_id: int = 1 << 21  # requester lane 0's id in the fault space

    def __post_init__(self):
        # fail at construction, not as NaN weights deep inside a run
        if not 0.0 <= self.p_drop <= 1.0:
            raise ValueError(f"p_drop must be within [0, 1] (got {self.p_drop})")
        if not 0.0 <= self.p_stale <= 1.0:
            raise ValueError(f"p_stale must be within [0, 1] (got {self.p_stale})")
        if self.max_retries < 0:
            raise ValueError(f"max_retries must be >= 0 (got {self.max_retries})")
        if self.release_after < 0:
            raise ValueError(f"release_after must be >= 0 (got {self.release_after})")

    @property
    def attempts_max(self) -> int:
        """Transmission budget per link per round (first try + retries)."""
        return self.max_retries + 1


def _threshold(p: float) -> int:
    """The integer threshold a probability compiles to (float64 product)."""
    return int(min(max(float(p), 0.0), 1.0) * _DRAW_MAX)


def _link_draw(seed: int, salt: int, r, requester_id, cand_id, t, *,
               partitionable: bool, device) -> torch.Tensor:
    """Int32 draws (in int64) in [0, _DRAW_MAX) of the chain ``PRNGKey(seed)
    -> salt -> round -> requester -> contributor -> attempt``; the four
    counters (ints or int64 tensors) broadcast against each other."""
    key = prng.fold_in(prng.prng_key(seed, device=device), salt)
    for v in (r, requester_id, cand_id, t):
        key = prng.fold_in(key, torch.as_tensor(v, dtype=torch.int64, device=device))
    return prng.randint(key, (), 0, _DRAW_MAX, partitionable=partitionable)


def _counters(r, requester_id, cand_ids):
    """``(rounds, requesters, ids)`` as int64 tensors on ``cand_ids``'
    device that broadcast to ``r.shape + ids.shape``: ``requester_id`` is an
    int or a tensor of ``cand_ids``' leading shape, ``r`` an int or a tensor
    of rounds."""
    ids = torch.as_tensor(cand_ids, dtype=torch.int64)
    req = torch.as_tensor(requester_id, dtype=torch.int64, device=ids.device)
    if req.dim():
        req = req[..., None]
    r_t = torch.as_tensor(r, dtype=torch.int64, device=ids.device)
    return r_t.reshape(r_t.shape + (1,) * ids.dim()), req, ids


def link_outcomes(fc: FaultConfig, r, requester_id, cand_ids, *,
                  partitionable: bool = True):
    """Per-link fault outcomes at round ``r``: Phase.DELIVER's world state.

    ``requester_id`` is an int or an (R,) tensor, ``cand_ids`` (N,) or
    (R, N); ``r`` an int, or a tensor of rounds that adds its shape in
    front.  Returns ``(delivered, attempts, stale)`` on ``cand_ids``'
    device: bool, int64 transmissions made (1 ... ``attempts_max``; an
    undelivered link exhausts the budget) and bool (the delivered payload
    is the round-(r-1) image; only meaningful where delivered).  Whether a
    link counts (a member, not blocked) is the caller's mask."""
    r_t, req, ids = _counters(r, requester_id, cand_ids)
    dev = ids.device
    n_att = fc.attempts_max
    tries = torch.arange(n_att, dtype=torch.int64, device=dev)
    draws = _link_draw(fc.seed, _SALT_DROP, r_t[..., None], req[..., None], ids[..., None],
                       tries, partitionable=partitionable, device=dev)
    ok = draws >= _threshold(fc.p_drop)
    delivered = ok.any(dim=-1)
    first = torch.where(ok, tries, n_att).amin(dim=-1)     # first successful attempt
    attempts = torch.where(delivered, first + 1, n_att)
    stale = delivered & (_link_draw(fc.seed, _SALT_STALE, r_t, req, ids, 0,
                                    partitionable=partitionable, device=dev)
                         < _threshold(fc.p_stale))
    return delivered, attempts, stale


def blocked_mask(fc: FaultConfig, r, requester_id, cand_ids, *,
                 partitionable: bool = True) -> torch.Tensor:
    """Bool, shaped as :func:`link_outcomes`' outputs: links whose previous
    ``release_after`` rounds ALL failed to deliver.  Closed form: the
    delivered bits of rounds ``r - release_after ... r - 1`` are drawn
    again (rounds below 0 wrap in the draw and count as delivered), so
    both engines and a resumed run agree without replaying history."""
    ids = torch.as_tensor(cand_ids, dtype=torch.int64)
    r_t = torch.as_tensor(r, dtype=torch.int64, device=ids.device)
    k = fc.release_after
    if k <= 0:
        return torch.zeros(tuple(r_t.shape) + tuple(ids.shape), dtype=torch.bool,
                           device=ids.device)
    back = torch.arange(1, k + 1, dtype=torch.int64, device=ids.device)
    rk = r_t[None] - back.reshape((k,) + (1,) * r_t.dim())
    delivered, _, _ = link_outcomes(fc, rk, requester_id, ids, partitionable=partitionable)
    before = (rk < 0).reshape(rk.shape + (1,) * ids.dim())
    return (~(delivered | before)).all(dim=0)

