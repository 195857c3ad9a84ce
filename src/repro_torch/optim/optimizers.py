"""Adam over parameter trees, as ``repro.optim.optimizers`` writes it.

The update is ``-lr * (m / bc1) / (sqrt(v / bc2) + eps)`` with fp32
moments, the same expression and order as the JAX package (not
``torch.optim.Adam``, which folds the bias corrections differently).
API mirrors the JAX package:

    opt = adam(1e-3)
    state = opt.init(params)
    updates, state = opt.update(grads, state, params)
    params = apply_updates(params, updates)

:func:`lane_adam_step` is the fleet's form of the same update on a flat
(L, P) buffer, with a per-lane step count.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import torch

from repro_torch.utils.tree import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable
    update: Callable  # (grads, state, params) -> (updates, state)


class AdamState(NamedTuple):
    step: int
    mu: object
    nu: object


def adam(lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
         weight_decay: float = 0.0, grad_clip: Optional[float] = None) -> Optimizer:
    def init(params):
        zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        return AdamState(step=0, mu=tree_map(zeros, params),
                         nu=tree_map(zeros, params))

    def update(grads, state, params):
        step = state.step + 1
        if grad_clip is not None:
            gnorm = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                                   for g in tree_leaves(grads)))
            scale = torch.clamp_max(grad_clip / (gnorm + 1e-9), 1.0)
            grads = tree_map(lambda g: g * scale, grads)
        mu = tree_map(lambda m, g: b1 * m + (1 - b1) * g.float(), state.mu, grads)
        nu = tree_map(lambda v, g: b2 * v + (1 - b2) * torch.square(g.float()),
                      state.nu, grads)
        # fp32 bias corrections, as jnp computes b ** step.astype(float32)
        step_f = torch.tensor(float(step), dtype=torch.float32)
        bc1 = float(1 - torch.pow(torch.tensor(b1, dtype=torch.float32), step_f))
        bc2 = float(1 - torch.pow(torch.tensor(b2, dtype=torch.float32), step_f))

        def upd(m, v, p):
            u = -(lr * (m / bc1) / (torch.sqrt(v / bc2) + eps))
            if weight_decay:
                u = u - lr * weight_decay * p.float()
            return u.to(p.dtype)

        updates = tree_map(upd, mu, nu, params)
        return updates, AdamState(step=step, mu=mu, nu=nu)

    return Optimizer(init=init, update=update)


def apply_updates(params, updates):
    return tree_map(torch.add, params, updates)


class LaneAdamState(NamedTuple):
    step: torch.Tensor   # (L,) int32 steps taken by each lane
    mu: torch.Tensor     # (L, P) fp32
    nu: torch.Tensor     # (L, P) fp32


def lane_adam_init(flat: torch.Tensor) -> LaneAdamState:
    return LaneAdamState(
        step=torch.zeros(flat.shape[0], dtype=torch.int32, device=flat.device),
        mu=torch.zeros(flat.shape, dtype=torch.float32, device=flat.device),
        nu=torch.zeros(flat.shape, dtype=torch.float32, device=flat.device))


def lane_adam_step(flat: torch.Tensor, grads: torch.Tensor, state: LaneAdamState,
                   take: torch.Tensor, lr: float, b1: float = 0.9,
                   b2: float = 0.999, eps: float = 1e-8):
    """One Adam step of every lane of a flat (L, P) buffer, as
    :func:`adam` writes it, with each lane's own step count and fp32 bias
    corrections.  A lane whose ``take`` is False (its minibatch weights
    sum to 0) keeps params, moments and count, with no host sync.
    Returns ``(flat, state)``."""
    step = state.step + 1
    mu = b1 * state.mu + (1 - b1) * grads
    nu = b2 * state.nu + (1 - b2) * torch.square(grads)
    step_f = step.to(torch.float32)
    bc1 = 1 - torch.pow(torch.tensor(b1, dtype=torch.float32, device=flat.device), step_f)
    bc2 = 1 - torch.pow(torch.tensor(b2, dtype=torch.float32, device=flat.device), step_f)
    upd = -(lr * (mu / bc1[:, None]) / (torch.sqrt(nu / bc2[:, None]) + eps))
    t = take[:, None]
    return (torch.where(t, flat + upd, flat),
            LaneAdamState(step=torch.where(take, step, state.step),
                          mu=torch.where(t, mu, state.mu),
                          nu=torch.where(t, nu, state.nu)))
