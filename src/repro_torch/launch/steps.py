"""Step builders: the LM loss and the federated train step, the prefill
step and the serve (decode) step (port of ``repro.launch.steps`` without a
device mesh).

The reference makes every client of the FL fleet one shard of the mesh's
client axes and runs the strategy's aggregation collective inside a
``shard_map``.  The port has no mesh yet (ROADMAP slice H), so
:func:`make_federated_train_step` gives the reference's no-client-axes
step (Adam on the loss's gradient, which XLA would reduce over the mesh);
client-stacked rounds with the strategy's mixing run through
``repro_torch.core.federated.FederatedTrainer``.
"""

from __future__ import annotations

import torch

from repro_torch.core.topology import AggregationStrategy
from repro_torch.models import Transformer, cross_entropy_loss
from repro_torch.optim import adam, apply_updates
from repro_torch.utils.tree import tree_map, value_and_grad

MTP_LOSS_WEIGHT = 0.3


def lm_loss(model: Transformer, params, batch):
    out = model.forward(params, batch)
    logits = out["logits"]
    labels = batch["labels"]
    if logits.shape[1] != labels.shape[1]:  # VLM prefix tokens carry no labels
        logits = logits[:, -labels.shape[1]:]
    loss = cross_entropy_loss(logits.reshape(-1, logits.shape[-1]), labels.reshape(-1))
    loss = loss + out["aux_loss"]
    if "mtp_logits" in out:
        mtp = out["mtp_logits"]
        if mtp.shape[1] != labels.shape[1]:
            mtp = mtp[:, -labels.shape[1]:]
        # MTP head predicts token t+2: shift labels left by one more step
        mtp_labels = torch.roll(labels, -1, dims=1)
        loss = loss + MTP_LOSS_WEIGHT * cross_entropy_loss(
            mtp[:, :-1].reshape(-1, mtp.shape[-1]), mtp_labels[:, :-1].reshape(-1))
    return loss


# ---------------------------------------------------------------------------
# federated parameter/opt-state stacking
# ---------------------------------------------------------------------------


def stack_for_clients(tree, C: int):
    """Every leaf repeated over a new leading client axis of size C (a copy)."""
    return tree_map(lambda x: x.expand((C,) + tuple(x.shape)).clone(), tree)


# ---------------------------------------------------------------------------
# train step
# ---------------------------------------------------------------------------


def make_federated_train_step(model: Transformer, mesh, strategy: AggregationStrategy,
                              lr: float = 1e-4):
    """Returns (train_step, opt).  train_step(params, opt_state, batch,
    mask) -> (params, opt_state, loss): one step of Adam on the batch's
    ``lm_loss``, the reference's step for a fleet with no client axes.
    The client-sharded step (``mesh`` given and a strategy other than
    ``"none"``) needs the mesh tooling of ROADMAP slice H."""
    if mesh is not None and strategy.kind != "none":
        raise NotImplementedError(
            "the client-sharded federated train step needs a device mesh, which "
            "comes with ROADMAP slice H; pass mesh=None or strategy kind 'none'")
    opt = adam(lr)

    def plain_step(params, opt_state, batch, mask):
        del mask
        loss, grads = value_and_grad(lambda p: lm_loss(model, p, batch), params)
        with torch.no_grad():
            upd, opt_state = opt.update(grads, opt_state, params)
            return apply_updates(params, upd), opt_state, loss

    return plain_step, opt


# ---------------------------------------------------------------------------
# prefill / serve steps
# ---------------------------------------------------------------------------


def make_prefill_step(model: Transformer):
    def prefill_step(params, batch):
        out = model.forward(params, batch, last_logit_only=True)
        return out["logits"]

    return prefill_step


def make_serve_step(model: Transformer, mla_absorbed: bool = False):
    def serve_step(params, cache, tokens, pos, memory=None):
        logits, cache = model.decode_step(params, tokens, cache, pos,
                                          memory=memory, mla_absorbed=mla_absorbed)
        return logits, cache

    return serve_step
