"""Architecture registry: ``--arch <id>`` -> ModelConfig (port of
``repro.configs``).

Two CI-sized debug presets (the only sizes anything in this repo
actually trains or serves on this CPU toolchain) plus the EnFed paper's
own HAR classifiers.  The ten full-size LLM preset modules that used to
live here were dead weight: every engine, test, and driver ran their
``.smoke()`` reductions, never the billion-parameter specs, so the
presets below ARE those reductions, kept honest under their own names.

* ``debug-dense`` — dense GQA decoder with QKV bias: the plain
  attention + SwiGLU path every dense-family code path shares.
* ``debug-moe``  — 4-expert top-2 MoE.  Its vocab (513) is deliberately
  odd so it is never divisible by a model axis — the embedding sharding
  rules must take the d_model-axis fallback (exercised in
  the reference's tests/test_distributed.py).
"""

from __future__ import annotations

from typing import Dict

from repro_torch.models.classifiers import LSTMClassifierConfig, MLPClassifierConfig
from repro_torch.models.config import ModelConfig, MoEConfig

DEBUG_DENSE = ModelConfig(
    name="debug-dense",
    family="dense",
    citation="debug preset",
    num_layers=2,
    d_model=128,
    num_heads=4,
    num_kv_heads=2,
    head_dim=32,
    d_ff=256,
    vocab_size=512,
    block_pattern=("attn",),
    qkv_bias=True,
    dtype="float32",
)

DEBUG_MOE = ModelConfig(
    name="debug-moe",
    family="moe",
    citation="debug preset",
    num_layers=2,
    d_model=128,
    num_heads=4,
    num_kv_heads=2,
    head_dim=32,
    d_ff=256,
    vocab_size=513,  # odd on purpose: forces the embedding-sharding fallback
    block_pattern=("attn",),
    moe=MoEConfig(num_experts=4, num_experts_per_tok=2,
                  num_shared_experts=0, d_ff_expert=128),
    dtype="float32",
)

ARCHS: Dict[str, ModelConfig] = {c.name: c for c in [DEBUG_DENSE, DEBUG_MOE]}

# the EnFed paper's own models (Table III)
PAPER_LSTM = LSTMClassifierConfig(input_dim=6, seq_len=64, hidden=64, num_classes=6)
PAPER_MLP = MLPClassifierConfig(input_dim=8, hidden=(64, 32), num_classes=5)

# input shapes assigned to this paper
INPUT_SHAPES = {
    "train_4k": {"seq_len": 4096, "global_batch": 256, "kind": "train"},
    "prefill_32k": {"seq_len": 32_768, "global_batch": 32, "kind": "prefill"},
    "decode_32k": {"seq_len": 32_768, "global_batch": 128, "kind": "decode"},
    "long_500k": {"seq_len": 524_288, "global_batch": 1, "kind": "decode"},
}


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(ARCHS)}")
    return ARCHS[name]


def list_archs():
    return sorted(ARCHS)


def shape_supported(cfg: ModelConfig, shape_name: str) -> bool:
    """long_500k only runs for sub-quadratic-decode architectures
    (DESIGN.md §Arch-applicability); everything else runs all shapes."""
    if shape_name == "long_500k":
        return cfg.supports_long_decode
    return True
