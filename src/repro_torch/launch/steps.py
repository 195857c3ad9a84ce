"""Step builders of the serving path: the prefill step and the serve
(decode) step (port of the serving half of ``repro.launch.steps``).

The federated train step (``lm_loss``, ``make_federated_train_step``) is
the training half of the reference file and comes with the LM zoo's
training slice.
"""

from __future__ import annotations

from repro_torch.models import Transformer


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
