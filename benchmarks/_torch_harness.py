"""Shared experiment harness for the paper-table benchmarks, on repro_torch.

The twin of ``benchmarks/_harness.py``: the same two synthetic datasets,
client fleet, constants and EnFed / CFL / DFL(mesh,ring) / cloud-only
sessions (paper Table III: Adam, categorical cross-entropy; local epochs
reduced from the paper's 100 to 8), run by the PyTorch/CUDA port.

``build_scenario(..., device=None)`` builds the task on the GPU and raises
on a host without one; ``device="cpu"`` runs every kernel's plain PyTorch
twin on the host.  The scenario warms up before any timed run: the
model's first fit and evaluate, the kernels' build and the first launch
of eq. 14 and of AES at the scenario's parameter count.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import (CFLLearner, DFLLearner, EnFedConfig, EnFedSession,
                              SupervisedTask, cloud_only_baseline, make_fleet)
from repro_torch.data import (CaloriesDatasetConfig, HARDatasetConfig,
                              dirichlet_partition, make_calories_tabular,
                              make_har_windows)
from repro_torch.kernels.common import resolve_device
from repro_torch.models import (LSTMClassifier, LSTMClassifierConfig, MLPClassifier,
                                MLPClassifierConfig)
from repro_torch.utils.tree import tree_size

EPOCHS = 8          # paper: 100 (reduced; see §Deviations)
BATCH = 32          # B_A
TARGET = 0.95       # A_A: EnFed stops at the desired personalized accuracy
TARGET_DFL = 0.96   # DFL runs until a 'generalized model' (paper §IV-B)
TARGET_CFL = 0.98   # CFL runs until an 'optimized global model' (paper: 99.9%)
MAX_ROUNDS = 10     # R_A
N_CLIENTS = 6       # requester + 5 supporters (paper's VM setup)
SEQ_LEN = 32


@dataclasses.dataclass
class Scenario:
    name: str
    task: SupervisedTask
    shards: list
    own_train: tuple
    own_test: tuple       # requester's personalized test split (EnFed target)
    global_test: tuple    # union-distribution holdout (CFL/DFL targets)
    pooled: tuple


def warm_kernels(n_params: int, device) -> None:
    """Pay the kernels' build and the first launch of eq. 14 at (1, N, P)
    for every N the runs use (EnFed's 2-5 contributors, CFL's 6 clients)
    and of AES over one fp32 update, so no timed run pays them.  On the
    CPU the ops run their twins."""
    from repro_torch.core import crypto
    from repro_torch.kernels import _build
    from repro_torch.kernels.fedavg.ops import fedavg_flat_batched

    if device.type == "cuda":
        _build.load()
    for n in range(2, N_CLIENTS + 1):
        fedavg_flat_batched(torch.zeros((1, n, n_params), device=device),
                            torch.ones((1, n), device=device))
    key = np.arange(16, dtype=np.uint8)
    crypto.encrypt_bytes(torch.zeros(4 * n_params, dtype=torch.uint8, device=device),
                         key, key[:8])
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def build_scenario(dataset: str, model_kind: str, seed: int = 0,
                   num_samples: int = 0, device=None) -> Scenario:
    """dataset: 'calories' (paper Dataset1) | 'har' (paper Dataset2).
    model_kind: 'lstm' | 'mlp'.  Default sizes give each of the 6 clients
    enough samples to reach the paper's accuracy band."""
    device = resolve_device(device)
    if num_samples == 0:
        num_samples = 9000 if dataset == "calories" else 3000
    if dataset == "har":
        x, y, _ = make_har_windows(HARDatasetConfig(num_samples=num_samples,
                                                    seq_len=SEQ_LEN, seed=seed))
    else:
        x, y = make_calories_tabular(CaloriesDatasetConfig(num_samples=num_samples,
                                                           seed=seed))
    n_classes = int(y.max()) + 1
    if model_kind == "lstm":
        if x.ndim == 2:  # tabular -> repeat as a short sequence for the LSTM
            x = np.repeat(x[:, None, :], 8, axis=1)
        task = SupervisedTask(LSTMClassifier(LSTMClassifierConfig(
            input_dim=x.shape[-1], seq_len=x.shape[1], hidden=64,
            num_classes=n_classes), device=device), lr=3e-3)
    else:
        if x.ndim == 3:  # sequence -> summary features for the MLP
            x = np.concatenate([x.mean(1), x.std(1)], axis=-1)
        task = SupervisedTask(MLPClassifier(MLPClassifierConfig(
            input_dim=x.shape[-1], hidden=(64, 32), num_classes=n_classes),
            device=device), lr=3e-3)

    parts = dirichlet_partition(y, N_CLIENTS, alpha=1.0, seed=seed)
    shards = [(x[p], y[p]) for p in parts]
    own_x, own_y = shards[0]
    n = int(len(own_x) * 0.8)
    # warm up so measured wall-times exclude the first call of every path
    warm = task.init(seed=999)
    warm, _ = task.fit(warm, (own_x[:BATCH], own_y[:BATCH]), 1, BATCH, seed=0)
    task.evaluate(warm, (own_x[:BATCH], own_y[:BATCH]))
    warm_kernels(tree_size(warm), device)
    rng = np.random.default_rng(seed + 7)
    hold = rng.permutation(len(x))[: max(len(x) // 10, 200)]
    return Scenario(
        name=f"{dataset}/{model_kind}", task=task, shards=shards,
        own_train=(own_x[:n], own_y[:n]), own_test=(own_x[n:], own_y[n:]),
        global_test=(x[hold], y[hold]), pooled=(x, y))


def run_enfed(sc: Scenario, n_contrib: int = 5, epochs: int = EPOCHS,
              target: float = TARGET, seed: int = 0, encrypt: bool = True,
              pretrain_epochs: int = 6):
    fleet = make_fleet(n_contrib, seed=seed + 1, p_has_model=1.0)
    states = {}
    for i, dev in enumerate(fleet):
        dev.reservation_price = 0.4
        p = sc.task.init(seed=10 + i)
        p, _ = sc.task.fit(p, sc.shards[(i % (N_CLIENTS - 1)) + 1],
                           epochs=pretrain_epochs, batch_size=BATCH, seed=i)
        states[dev.device_id] = {"params": p,
                                 "data": sc.shards[(i % (N_CLIENTS - 1)) + 1]}
    cfg = EnFedConfig(desired_accuracy=target, max_rounds=MAX_ROUNDS,
                      n_max=n_contrib, epochs=epochs, batch_size=BATCH,
                      encrypt=encrypt, seed=seed)
    return EnFedSession(sc.task, sc.own_train, sc.own_test, fleet, states, cfg,
                        device=sc.task.device).run()


def run_cfl(sc: Scenario, epochs: int = EPOCHS, target: float = TARGET_CFL, seed: int = 0):
    client_data = [sc.own_train] + sc.shards[1:N_CLIENTS]
    cfg = EnFedConfig(desired_accuracy=target, max_rounds=MAX_ROUNDS,
                      epochs=epochs, batch_size=BATCH, seed=seed)
    return CFLLearner(sc.task, client_data, sc.global_test).run_config(cfg)


def run_dfl(sc: Scenario, topology: str, n_nodes: int = N_CLIENTS,
            epochs: int = EPOCHS, target: float = TARGET_DFL, seed: int = 0):
    client_data = ([sc.own_train] + sc.shards[1:N_CLIENTS])[:n_nodes]
    cfg = EnFedConfig(desired_accuracy=target, max_rounds=MAX_ROUNDS,
                      epochs=epochs, batch_size=BATCH, seed=seed)
    return DFLLearner(sc.task, client_data, sc.global_test, topology).run_config(cfg)


def run_cloud(sc: Scenario, epochs: int = EPOCHS, seed: int = 0):
    return cloud_only_baseline(sc.task, sc.pooled, sc.own_test,
                               epochs=epochs, batch_size=BATCH, seed=seed)
