"""The port's hand-written Hopper kernels, one package each:
``kernel.py`` (ctypes launchers of ``csrc/<name>.cu`` with their launch
counts), ``ref.py`` (the plain PyTorch twins, which are the spec) and
``ops.py`` (dispatch on the tensor's device)."""

from __future__ import annotations

from typing import Dict

from repro_torch.kernels.aes_ctr import kernel as _aes_ctr
from repro_torch.kernels.fedavg import kernel as _fedavg
from repro_torch.kernels.lstm_cell import kernel as _lstm_cell
from repro_torch.kernels.quantize import kernel as _quantize
from repro_torch.kernels.robust import kernel as _robust

# kernel name -> (launcher module, name of its launch counter)
_COUNTERS = {
    "fedavg": (_fedavg, "launches"),
    "fedavg_q8": (_fedavg, "q8_launches"),
    "lstm_cell": (_lstm_cell, "launches"),
    "lstm_cell_bwd": (_lstm_cell, "bwd_launches"),
    "aes_ctr": (_aes_ctr, "launches"),
    "quantize": (_quantize, "launches"),
    "dequantize": (_quantize, "dequantize_launches"),
    "trimmed_mean": (_robust, "trimmed_mean_launches"),
    "trimmed_mean_q8": (_robust, "trimmed_mean_q8_launches"),
    "median": (_robust, "median_launches"),
    "median_q8": (_robust, "median_q8_launches"),
    "sqnorm": (_robust, "sqnorm_launches"),
    "sqnorm_q8": (_robust, "sqnorm_q8_launches"),
}


def launch_counts() -> Dict[str, int]:
    """Launches of each kernel since the last reset."""
    return {name: getattr(mod, attr) for name, (mod, attr) in _COUNTERS.items()}


def reset_launch_counts() -> None:
    for mod, attr in _COUNTERS.values():
        setattr(mod, attr, 0)
