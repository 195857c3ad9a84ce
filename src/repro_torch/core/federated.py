"""The supervised task of the paper's classifiers (the ``SupervisedTask``
part of ``repro.core.federated``): masked Adam fit over the counter-based
schedule, and accuracy.

Data arrive as numpy ``(x, y)`` pairs, as in the JAX package, and are
moved to the model's device once per call.  The schedule is computed on
the host, so whether a step has any weight is known there without a
device sync: a step whose weights are all zero is skipped, which is
exactly what the JAX step's ``tree_where`` keeps (params, moments and the
step count unchanged, loss 0).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import schedule
from repro_torch.models.classifiers import accuracy as _accuracy
from repro_torch.models.classifiers import masked_cross_entropy_loss
from repro_torch.optim import adam, apply_updates
from repro_torch.utils.tree import tree_from_leaves, tree_leaves, tree_map


class SupervisedTask:
    """Local fit/evaluate for one classifier.

    ``threefry_partitionable`` selects which of jax's two threefry modes
    the minibatch schedule reproduces (``jax_threefry_partitionable``).
    """

    def __init__(self, model, lr: float = 1e-3, *,
                 threefry_partitionable: bool = True):
        self.model = model
        self.lr = lr
        self.threefry_partitionable = threefry_partitionable
        self._opt = adam(lr)

    @property
    def device(self) -> torch.device:
        return self.model.device

    def init(self, seed: int = 0) -> dict:
        gen = torch.Generator().manual_seed(int(seed))
        return self.model.init(gen)

    def _to_device(self, data):
        x, y = data
        return (torch.as_tensor(np.asarray(x, np.float32)).to(self.device),
                torch.as_tensor(np.asarray(y)).long().to(self.device))

    def _step(self, params, opt_state, xb, yb, wb):
        """One masked Adam step; returns (params, opt_state, loss)."""
        live = tree_map(lambda p: p.detach().requires_grad_(True), params)
        loss = masked_cross_entropy_loss(self.model.logits(live, xb), yb, wb)
        grads = torch.autograd.grad(loss, tree_leaves(live))
        grad_tree = tree_from_leaves(params, grads)
        with torch.no_grad():
            updates, new_opt = self._opt.update(grad_tree, opt_state, params)
            new_params = apply_updates(params, updates)
        return new_params, new_opt, loss.detach()

    def fit(self, params, data, epochs: int, batch_size: int, seed: int = 0):
        """Epochs of Adam over the derived minibatches.  Returns
        ``(params, losses)``, one mean loss per epoch."""
        x, y = self._to_device(data)
        idx, w = schedule.minibatch_plan(
            seed, epochs=epochs, n=len(x), batch=batch_size,
            partitionable=self.threefry_partitionable)
        steps = idx.shape[1]
        live = (w.sum(dim=-1) > 0).tolist()     # host: no device sync
        idx_d, w_d = idx.to(self.device), w.to(self.device)
        opt_state = self._opt.init(params)
        losses = []
        for e in range(epochs):
            ep = []
            for s in range(steps):
                if not live[e][s]:
                    continue           # all-zero weights: the step is a no-op
                sel = idx_d[e, s]
                params, opt_state, loss = self._step(
                    params, opt_state, x[sel], y[sel], w_d[e, s])
                ep.append(loss)
            ep_vals = torch.stack(ep).tolist() if ep else []
            losses.append(sum(ep_vals) / steps)
        return params, losses

    def evaluate(self, params, data) -> float:
        x, y = self._to_device(data)
        with torch.no_grad():
            return float(_accuracy(self.model.logits(params, x), y))
