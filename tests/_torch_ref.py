"""Helpers the port's parity tests share (not a test module).

Model init is the one draw the port does not reproduce (``ROADMAP.md``
"Randomness"), so a parity test's port task inits from the reference's
``task.init(seed)``, converted, under the threefry mode the task names.
"""

import contextlib

import jax
import numpy as np

import repro_torch.core as tcore
from repro_torch.utils.tree import from_jax_params


@contextlib.contextmanager
def threefry(partitionable):
    """``jax_threefry_partitionable`` set to ``partitionable`` inside the
    block, restored after."""
    old = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", partitionable)
    try:
        yield
    finally:
        jax.config.update("jax_threefry_partitionable", old)


class RefInitTask(tcore.SupervisedTask):
    """The port's task with the reference's init, converted: ``jtask``'s
    learning rate, and the threefry mode ``partitionable`` (by default the
    one jax has when the task is made) for its schedule and its inits."""

    def __init__(self, model, jtask, partitionable=None):
        if partitionable is None:
            partitionable = jax.config.jax_threefry_partitionable
        super().__init__(model, lr=jtask.lr, threefry_partitionable=partitionable)
        self._jtask = jtask

    def init(self, seed=0):
        with threefry(self.threefry_partitionable):
            jp = self._jtask.init(seed)
        return from_jax_params(jax.tree_util.tree_map(np.asarray, jp), self.device)


def torch_model_config(cfg):
    """The port's ``ModelConfig`` with every field of the reference's
    ``cfg`` (its MoE and MLA sub-configs converted too)."""
    import dataclasses

    from repro_torch.models import config as tconf

    fields = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    if cfg.moe is not None:
        fields["moe"] = tconf.MoEConfig(**dataclasses.asdict(cfg.moe))
    if cfg.mla is not None:
        fields["mla"] = tconf.MLAConfig(**dataclasses.asdict(cfg.mla))
    return tconf.ModelConfig(**fields)


def np_tree(tree):
    """A reference pytree as a nested dict of numpy arrays."""
    return jax.tree_util.tree_map(np.asarray, tree)
