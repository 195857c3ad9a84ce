"""The paper's HAR data-analysis models: an LSTM and an MLP classifier
(port of ``repro.models.classifiers``).

Both are ``nn.Module``s whose parameters carry the JAX names (``wx``,
``wh``, ``b``, ``w_out``, ``b_out``; ``layer{i}.w`` / ``layer{i}.b``).
Training runs functionally: :meth:`logits` takes a parameter tree (nested
dict of tensors, the JAX package's layout) and the module's own
parameters are just one such tree.  The LSTM's ``lax.scan`` over time is
one call of the differentiable sequence op
(``repro_torch.kernels.lstm_cell.ops.lstm_seq_autograd``): a hand-written
kernel for the T steps of the forward and one for the backward on the
card, their plain twins on the CPU.  The output head and the MLP stay
``torch.matmul``, as the JAX package leaves them to XLA.

:meth:`lane_logits` is the fleet's form: every parameter leaf carries a
leading lane axis L (each lane trains its own params) and x is (L, B, ...).
:meth:`logits` is its case L = 1, for both models.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
from torch import nn

from repro_torch.kernels.common import resolve_device
from repro_torch.kernels.lstm_cell.ops import lstm_seq_autograd
from repro_torch.models.layers import dense_init
from repro_torch.utils.tree import tree_map


@dataclasses.dataclass(frozen=True)
class LSTMClassifierConfig:
    input_dim: int        # sensor features per timestep
    seq_len: int          # window length
    hidden: int = 64
    num_classes: int = 6


@dataclasses.dataclass(frozen=True)
class MLPClassifierConfig:
    input_dim: int
    hidden: Tuple[int, ...] = (64, 32)   # paper Table III
    num_classes: int = 5


def _param(shape, device) -> nn.Parameter:
    return nn.Parameter(torch.zeros(shape, dtype=torch.float32, device=device))


class _Classifier(nn.Module):
    """Shared plumbing: device, the module's parameters as a tree, and a
    forward that runs :meth:`logits` over them."""

    def __init__(self, device=None):
        super().__init__()
        self.device = resolve_device(device)

    def param_tree(self) -> dict:
        tree: dict = {}
        for name, p in self.named_parameters():
            node = tree
            *parents, leaf = name.split(".")
            for key in parents:
                node = node.setdefault(key, {})
            node[leaf] = p
        return tree

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.logits(self.param_tree(), x)

    def logits(self, params: dict, x: torch.Tensor) -> torch.Tensor:
        """One set of params, x (B, ...) -> logits (B, num_classes): the
        lane form at L = 1."""
        return self.lane_logits(tree_map(lambda p: p[None], params), x[None])[0]


# ---------------------------------------------------------------------------
# LSTM
# ---------------------------------------------------------------------------


class LSTMClassifier(_Classifier):
    def __init__(self, cfg: LSTMClassifierConfig, device=None):
        super().__init__(device)
        self.cfg = cfg
        H = cfg.hidden
        self.wx = _param((cfg.input_dim, 4 * H), self.device)
        self.wh = _param((H, 4 * H), self.device)
        self.b = _param((4 * H,), self.device)
        self.w_out = _param((H, cfg.num_classes), self.device)
        self.b_out = _param((cfg.num_classes,), self.device)

    def init(self, generator: torch.Generator) -> dict:
        cfg, H, dev = self.cfg, self.cfg.hidden, self.device
        return {
            "wx": dense_init(generator, cfg.input_dim, 4 * H, device=dev),
            "wh": dense_init(generator, H, 4 * H, device=dev),
            "b": torch.zeros((4 * H,), dtype=torch.float32, device=dev),
            "w_out": dense_init(generator, H, cfg.num_classes, device=dev),
            "b_out": torch.zeros((cfg.num_classes,), dtype=torch.float32, device=dev),
        }

    def lane_logits(self, params: dict, x: torch.Tensor) -> torch.Tensor:
        """Leaves (L, ...), x (L, B, T, F) -> logits (L, B, num_classes)."""
        L, B = x.shape[0], x.shape[1]
        steps = x.permute(0, 2, 1, 3).contiguous()   # (L, T, B, F): contiguous x_t
        h0 = torch.zeros((L, B, self.cfg.hidden), dtype=torch.float32, device=x.device)
        h, _ = lstm_seq_autograd(steps, h0, torch.zeros_like(h0), params["wx"],
                                 params["wh"], params["b"])
        return h @ params["w_out"] + params["b_out"].unsqueeze(-2)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------


class _Dense(nn.Module):
    def __init__(self, fan_in: int, fan_out: int, device):
        super().__init__()
        self.w = _param((fan_in, fan_out), device)
        self.b = _param((fan_out,), device)


class MLPClassifier(_Classifier):
    def __init__(self, cfg: MLPClassifierConfig, device=None):
        super().__init__(device)
        self.cfg = cfg
        dims = self._dims()
        for i in range(len(dims) - 1):
            self.add_module(f"layer{i}", _Dense(dims[i], dims[i + 1], self.device))

    def _dims(self):
        cfg = self.cfg
        return (cfg.input_dim,) + tuple(cfg.hidden) + (cfg.num_classes,)

    def init(self, generator: torch.Generator) -> dict:
        dims, dev = self._dims(), self.device
        return {
            f"layer{i}": {
                "w": dense_init(generator, dims[i], dims[i + 1], device=dev),
                "b": torch.zeros((dims[i + 1],), dtype=torch.float32, device=dev),
            }
            for i in range(len(dims) - 1)
        }

    def lane_logits(self, params: dict, x: torch.Tensor) -> torch.Tensor:
        """Leaves (L, ...), x (L, B, F) -> logits (L, B, num_classes)."""
        n = len(params)
        for i in range(n):
            lp = params[f"layer{i}"]
            x = torch.matmul(x, lp["w"]) + lp["b"].unsqueeze(-2)
            if i < n - 1:
                x = torch.relu(x)
        return x


# ---------------------------------------------------------------------------
# shared loss / metrics
# ---------------------------------------------------------------------------


def cross_entropy_loss(logits, labels):
    """Categorical cross-entropy (labels are int class ids): ``log_softmax``
    in fp32, each label's log-probability, then the mean."""
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    nll = -torch.gather(logp, -1, labels.long()[:, None])[:, 0]
    return torch.mean(nll)


def masked_cross_entropy_loss(logits, labels, weights):
    """Per-sample-weighted categorical cross-entropy; ``weights`` is the
    minibatch's 0/1 sample mask from the schedule.  Denominator
    ``max(sum(w), 1)``.  Logits (..., B, C), labels and weights (..., B)
    -> (...): with a lane axis, one loss per lane.  Lanes are independent,
    so the gradient of the sum over lanes is each lane's own gradient."""
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    nll = -torch.gather(logp, -1, labels.long()[..., None])[..., 0]
    return (torch.sum(nll * weights, dim=-1)
            / torch.clamp_min(torch.sum(weights, dim=-1), 1.0))


def accuracy(logits, labels):
    return torch.mean((torch.argmax(logits, dim=-1) == labels).to(torch.float32))
