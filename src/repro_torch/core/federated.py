"""High-level federated learners (port of ``repro.core.federated``).

* :class:`SupervisedTask` — local fit/evaluate of the paper's classifiers:
  masked Adam over the counter-based schedule, and accuracy.
* :class:`CFLLearner`, :class:`DFLLearner` — the paper's baselines (a
  virtual server for CFL; mesh/ring gossip for DFL), with eq. (4)-(7)
  cost reports for the *requesting* device (client 0).  They are the
  loop oracles of ``run_fleet(method="cfl"|"dfl")``.
* :func:`cloud_only_config` — the no-FL system of §IV-G.
* :class:`FederatedTrainer` — client-stacked FL for the LM zoo: each round
  every client takes its local Adam steps, then the strategy's mixing
  matrix mixes the clients' params.

Data arrive as numpy ``(x, y)`` pairs, as in the JAX package, and are
moved to the model's device once per call.  The schedule is computed on
the host, so whether a step has any weight is known there without a
device sync: a step whose weights are all zero is skipped, which is
exactly what the JAX step's ``tree_where`` keeps (params, moments and the
step count unchanged, loss 0).
"""

from __future__ import annotations

import dataclasses
import time
import warnings
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import aggregation, schedule, topology
from repro_torch.core.energy import CostModel, EnergyReport, update_wire_bytes
from repro_torch.models.classifiers import accuracy as _accuracy
from repro_torch.models.classifiers import masked_cross_entropy_loss
from repro_torch.optim import AdamState, adam, apply_updates
from repro_torch.utils.tree import (tree_bytes, tree_leaves, tree_map, tree_size,
                                    value_and_grad)


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
        loss, grads = value_and_grad(
            lambda p: masked_cross_entropy_loss(self.model.logits(p, xb), yb, wb), params)
        with torch.no_grad():
            updates, new_opt = self._opt.update(grads, opt_state, params)
            new_params = apply_updates(params, updates)
        return new_params, new_opt, loss

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


def _sync(device) -> None:
    """Wait for the device, so a host clock read next covers its work."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


# ---------------------------------------------------------------------------
# baselines: CFL, DFL and cloud-only
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class BaselineResult:
    accuracy: float
    rounds: int
    report: EnergyReport
    history: Dict[str, List[float]]
    params: object = None

    @property
    def history_raw(self) -> Dict[str, List[float]]:
        """Alias for ``history``, so call sites read every result type's
        raw traces the same way."""
        return self.history


def _as_enfed_config(target_accuracy: float, max_rounds: int, epochs: int,
                     batch_size: int, seed: int):
    """Legacy baseline kwargs -> the shared EnFedConfig surface."""
    from repro_torch.core.rounds import EnFedConfig

    return EnFedConfig(desired_accuracy=target_accuracy, max_rounds=max_rounds,
                       epochs=epochs, batch_size=batch_size, seed=seed)


class CFLLearner:
    """Centralized FedAvg: a virtual server, every client trains every round
    from the shared global, which the sample-count-weighted eq. (14)
    replaces (one launch a round).

    :meth:`run_config` takes the same :class:`EnFedConfig` fields as EnFed
    itself (``desired_accuracy``, ``max_rounds``, ``epochs``,
    ``batch_size``, ``seed``, ``compress`` for pricing) and the shared
    :class:`CostModel`.  Client ``ci`` fits round ``r`` with seed
    ``seed + 31 r + ci``; client 0 is the requesting device, whose fit wall
    time (host clock after a device sync) is the report's ``t_loc``.
    """

    def __init__(self, task: SupervisedTask, client_data: Sequence, requester_test,
                 cost_model: Optional[CostModel] = None):
        self.task = task
        self.client_data = list(client_data)
        self.requester_test = requester_test
        self.cost = cost_model or CostModel()

    def run_config(self, cfg) -> BaselineResult:
        """Run the baseline under an :class:`EnFedConfig`'s knobs."""
        params = self.task.init(cfg.seed)
        history = {"accuracy": [], "loss": []}
        measured = 0.0
        rounds = 0
        for r in range(cfg.max_rounds):
            updates, weights = [], []
            for ci, data in enumerate(self.client_data):
                t0 = time.perf_counter()
                p_c, _ = self.task.fit(params, data, cfg.epochs, cfg.batch_size,
                                       seed=cfg.seed + 31 * r + ci)
                if ci == 0:  # client 0 is "the requesting device"
                    _sync(self.task.device)
                    measured += time.perf_counter() - t0
                updates.append(p_c)
                weights.append(len(data[0]))
            params = aggregation.fedavg(updates, weights)
            acc = self.task.evaluate(params, self.requester_test)
            rounds = r + 1
            history["accuracy"].append(acc)
            if acc >= cfg.desired_accuracy:
                break
        # the compress knob prices the transport only: the baseline trains
        # and aggregates fp32, as the reference's does
        report = self.cost.cfl_session(
            rounds=rounds, num_params=tree_size(params),
            model_bytes=update_wire_bytes(
                tree_size(params), encrypt=False,
                compress=getattr(cfg, "compress", None),
                raw_bytes=tree_bytes(params)),
            num_samples=len(self.client_data[0][0]), epochs=cfg.epochs,
            measured_local_time=measured)
        return BaselineResult(accuracy=history["accuracy"][-1], rounds=rounds,
                              report=report, history=history, params=params)

    def run(self, *, target_accuracy: float, max_rounds: int, epochs: int,
            batch_size: int, seed: int = 0) -> BaselineResult:
        """Deprecated shim: private-kwarg form of :meth:`run_config`."""
        warnings.warn(
            "CFLLearner.run is deprecated; use CFLLearner.run_config "
            "(shared EnFedConfig surface)", DeprecationWarning, stacklevel=2)
        return self.run_config(_as_enfed_config(target_accuracy, max_rounds,
                                                epochs, batch_size, seed))


class DFLLearner:
    """Decentralized FL over a mesh or ring (the paper's DFL baseline):
    node ``i`` inits from ``seed + i``, fits round ``r`` with seed
    ``seed + 77 r + i`` from its own params, then every node takes its row
    of the mixing matrix (:func:`topology.group_mixing_matrix`), a plain
    product as in the reference.  Node 0 is the requesting device: it is
    scored, and its fit wall time is the report's ``t_loc``.
    :meth:`run_config` is the entry point, ``run`` its deprecated shim."""

    def __init__(self, task: SupervisedTask, client_data: Sequence, requester_test,
                 topology_kind: str = "mesh", cost_model: Optional[CostModel] = None):
        if topology_kind not in ("mesh", "ring"):
            raise ValueError(f"unknown dfl topology {topology_kind!r} (mesh|ring)")
        self.task = task
        self.client_data = list(client_data)
        self.requester_test = requester_test
        self.kind = topology_kind
        self.cost = cost_model or CostModel()

    def run_config(self, cfg) -> BaselineResult:
        """Run the baseline under an :class:`EnFedConfig`'s knobs."""
        n = len(self.client_data)
        node_params = [self.task.init(cfg.seed + i) for i in range(n)]
        strategy = topology.AggregationStrategy(
            kind="dfl_mesh" if self.kind == "mesh" else "dfl_ring")
        mix = torch.from_numpy(topology.group_mixing_matrix(n, strategy)).to(self.task.device)
        history = {"accuracy": []}
        measured = 0.0
        rounds = 0
        for r in range(cfg.max_rounds):
            for i, data in enumerate(self.client_data):
                t0 = time.perf_counter()
                node_params[i], _ = self.task.fit(node_params[i], data, cfg.epochs,
                                                  cfg.batch_size, seed=cfg.seed + 77 * r + i)
                if i == 0:
                    _sync(self.task.device)
                    measured += time.perf_counter() - t0
            stacked = tree_map(lambda *xs: torch.stack(xs), *node_params)
            mixed = topology.apply_mixing(stacked, mix)
            node_params = [tree_map(lambda x: x[i], mixed) for i in range(n)]
            acc = self.task.evaluate(node_params[0], self.requester_test)
            rounds = r + 1
            history["accuracy"].append(acc)
            if acc >= cfg.desired_accuracy:
                break
        p0 = node_params[0]
        report = self.cost.dfl_session(
            rounds=rounds, n_peers=n - 1, num_params=tree_size(p0),
            model_bytes=update_wire_bytes(
                tree_size(p0), encrypt=False,
                compress=getattr(cfg, "compress", None),
                raw_bytes=tree_bytes(p0)),
            num_samples=len(self.client_data[0][0]),
            epochs=cfg.epochs, topology=self.kind, measured_local_time=measured)
        return BaselineResult(accuracy=history["accuracy"][-1], rounds=rounds,
                              report=report, history=history, params=p0)

    def run(self, *, target_accuracy: float, max_rounds: int, epochs: int,
            batch_size: int, seed: int = 0) -> BaselineResult:
        """Deprecated shim: private-kwarg form of :meth:`run_config`."""
        warnings.warn(
            "DFLLearner.run is deprecated; use DFLLearner.run_config "
            "(shared EnFedConfig surface)", DeprecationWarning, stacklevel=2)
        return self.run_config(_as_enfed_config(target_accuracy, max_rounds,
                                                epochs, batch_size, seed))


def cloud_only_config(task: SupervisedTask, pooled_train, requester_test, cfg,
                      cost_model: Optional[CostModel] = None) -> BaselineResult:
    """§IV-G no-FL baseline on the shared EnFedConfig surface: the user
    ships raw data to the cloud, the cloud trains, the result comes back.

    The device-side report comes from :meth:`CostModel.cloud_session`;
    ``report.t_train`` is the end-to-end response time the paper plots:
    WAN upload + measured training wall time (host clock after a device
    sync) + the result round trip.
    """
    cost = cost_model or CostModel()
    params = task.init(cfg.seed)
    t0 = time.perf_counter()
    params, _ = task.fit(params, pooled_train, cfg.epochs, cfg.batch_size, seed=cfg.seed)
    _sync(task.device)
    t_cloud_train = time.perf_counter() - t0
    acc = task.evaluate(params, requester_test)
    x, _y = pooled_train
    report = cost.cloud_session(data_bytes=int(np.asarray(x).nbytes),
                                cloud_train_s=t_cloud_train)
    return BaselineResult(accuracy=acc, rounds=1, report=report,
                          history={"accuracy": [acc]}, params=params)


def cloud_only_baseline(task: SupervisedTask, pooled_train, requester_test, *,
                        epochs: int, batch_size: int,
                        cost_model: Optional[CostModel] = None, seed: int = 0):
    """Deprecated shim over :func:`cloud_only_config`.
    Returns (accuracy, response_time_s, params)."""
    res = cloud_only_config(
        task, pooled_train, requester_test,
        _as_enfed_config(0.0, 1, epochs, batch_size, seed),
        cost_model=cost_model)
    return res.accuracy, res.report.t_train, res.params


# ---------------------------------------------------------------------------
# client-stacked federated trainer for the architecture zoo
# ---------------------------------------------------------------------------


class FederatedTrainer:
    """FL over a stacked client axis.

    ``params`` leaves have shape (C, ...); each round every client runs
    ``local_steps`` of Adam on its own batches, then the topology mixing
    matrix is applied (CFL / DFL / EnFed neighborhoods with participation
    masks).  The reference vmaps the clients inside one jit program; here
    they run one after another, each with the reference's arithmetic, so
    the per-client semantics are the same.
    """

    def __init__(self, loss_fn: Callable, num_clients: int,
                 strategy: topology.AggregationStrategy, lr: float = 1e-3,
                 local_steps: int = 1):
        self.loss_fn = loss_fn            # (params, batch) -> scalar loss
        self.num_clients = num_clients
        self.strategy = strategy
        self.opt = adam(lr)
        self.local_steps = local_steps

    def init(self, params_one, opt_state_one=None):
        """``(stacked params, stacked AdamState)``: every leaf repeated over
        C clients.  The stacked Adam step is a (C,) int32 tensor, as the
        reference's stacked 0-d int32 step, so a checkpoint restores
        strictly in either package."""
        C = self.num_clients
        opt_one = opt_state_one if opt_state_one is not None else self.opt.init(params_one)
        stack = lambda t: tree_map(lambda x: x.expand((C,) + tuple(x.shape)).clone(), t)
        step = torch.full((C,), int(opt_one.step), dtype=torch.int32,
                          device=tree_leaves(params_one)[0].device)
        return stack(params_one), AdamState(step=step, mu=stack(opt_one.mu),
                                            nu=stack(opt_one.nu))

    def round(self, stacked_params, stacked_opt, batches, mask=None):
        """batches: dict of tensors with leading (C, local_steps) axes.
        Returns ``(mixed params, opt state, losses)``; ``losses`` (C,) is
        each client's mean loss over its local steps."""
        C = self.num_clients
        steps = stacked_opt.step.tolist()
        params_out, mu_out, nu_out, losses = [], [], [], []
        for c in range(C):
            p = tree_map(lambda x: x[c], stacked_params)
            s = AdamState(step=steps[c], mu=tree_map(lambda x: x[c], stacked_opt.mu),
                          nu=tree_map(lambda x: x[c], stacked_opt.nu))
            client_losses = []
            for t in range(self.local_steps):
                batch = {k: v[c, t] for k, v in batches.items()}
                loss, grads = value_and_grad(lambda q: self.loss_fn(q, batch), p)
                with torch.no_grad():
                    upd, s = self.opt.update(grads, s, p)
                    p = apply_updates(p, upd)
                client_losses.append(loss)
            steps[c] = s.step
            params_out.append(p)
            mu_out.append(s.mu)
            nu_out.append(s.nu)
            losses.append(torch.mean(torch.stack(client_losses)))
        stack = lambda trees: tree_map(lambda *xs: torch.stack(xs), *trees)
        dev = stacked_opt.step.device
        new_opt = AdamState(step=torch.tensor(steps, dtype=torch.int32, device=dev),
                            mu=stack(mu_out), nu=stack(nu_out))
        M = topology.mixing_matrix_torch(C, self.strategy, mask, device=dev)
        mixed = topology.apply_mixing(stack(params_out), M)
        return mixed, new_opt, torch.stack(losses)
