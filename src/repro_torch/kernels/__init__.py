"""The port's hand-written Hopper kernels, one package each:
``kernel.py`` (ctypes launcher of ``csrc/<name>.cu`` with its launch
count), ``ref.py`` (the plain PyTorch twin, which is the spec) and
``ops.py`` (dispatch on the tensor's device)."""

from __future__ import annotations

from typing import Dict

from repro_torch.kernels.aes_ctr import kernel as _aes_ctr
from repro_torch.kernels.fedavg import kernel as _fedavg
from repro_torch.kernels.lstm_cell import kernel as _lstm_cell

_KERNELS = {"fedavg": _fedavg, "lstm_cell": _lstm_cell, "aes_ctr": _aes_ctr}


def launch_counts() -> Dict[str, int]:
    """Launches of each kernel since the last reset."""
    return {name: mod.launches for name, mod in _KERNELS.items()}


def reset_launch_counts() -> None:
    for mod in _KERNELS.values():
        mod.launches = 0
