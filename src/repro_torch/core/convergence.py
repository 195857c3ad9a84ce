"""Convergence criteria (paper §III-C, eqs. 10-21; copy of
``repro.core.convergence``, which needs nothing of JAX).

The paper's convergence argument: each contributor's local loss delta
``L(w^q) - L(w^{q+1}) -> 0`` as q -> E_j (eq. 13); the aggregated loss is
the mean of contributor losses (eq. 15); and the requester's local fit
converges the same way (eq. 21).  Operationally we check the loss-delta
criterion on recorded histories.
"""

from __future__ import annotations

from typing import Sequence


def loss_delta_converged(losses: Sequence[float], tol: float = 1e-3,
                         patience: int = 2) -> bool:
    """True when the last ``patience`` consecutive loss deltas are < tol
    (the empirical form of eq. (12)/(20))."""
    if len(losses) < patience + 1:
        return False
    deltas = [abs(losses[i - 1] - losses[i]) for i in range(len(losses) - patience, len(losses))]
    return all(d < tol for d in deltas)


def aggregated_loss(contributor_losses: Sequence[float]) -> float:
    """Eq. (15): L1(w_M) = (1/N_c) * sum_j L(w_j)."""
    if not contributor_losses:
        raise ValueError("no contributors")
    return float(sum(contributor_losses) / len(contributor_losses))
