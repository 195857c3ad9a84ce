"""Model configuration (port of ``repro.models.config``).

One :class:`ModelConfig` describes every architecture family in the zoo:
dense GQA decoders, MoE (incl. DeepSeek-V3 MLA + shared/routed experts),
SSM (xLSTM sLSTM/mLSTM), hybrid (RecurrentGemma RG-LRU + local attention),
audio encoder-decoder (Seamless backbone) and VLM (LLaVA-NeXT backbone).

The per-layer block sequence is expressed as a cyclic ``block_pattern``;
layer ``i`` gets ``block_pattern[i % len(block_pattern)]``.  Block types:

* ``"attn"``        full-causal GQA attention
* ``"swa"``         sliding-window GQA attention (``sliding_window``)
* ``"local"``       RecurrentGemma-style local attention (``local_window``)
* ``"mla"``         DeepSeek multi-head latent attention
* ``"rglru"``       RecurrentGemma Griffin recurrent block (conv + RG-LRU)
* ``"mlstm"``       xLSTM matrix-memory LSTM block
* ``"slstm"``       xLSTM scalar-memory LSTM block

Every attention-ish block is followed by the config's FFN (dense SwiGLU or
MoE); recurrent xLSTM blocks embed their own projections (``d_ff == 0``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    num_experts_per_tok: int
    num_shared_experts: int = 0
    d_ff_expert: int = 0            # expert hidden dim (falls back to d_ff)
    router_aux_loss_coef: float = 0.01
    # Baseline dispatch is dense one-hot einsum (XLA lowers to all-gather);
    # "a2a" switches to the shard_map all-to-all schedule (perf hillclimb).
    dispatch: str = "einsum"


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-V3 multi-head latent attention dims [arXiv:2412.19437]."""

    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    citation: str = ""

    head_dim: Optional[int] = None   # None -> d_model // num_heads
    block_pattern: Tuple[str, ...] = ("attn",)
    qkv_bias: bool = False
    sliding_window: int = 4096       # for "swa" blocks
    local_window: int = 2048         # for "local" blocks
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    logit_softcap: float = 0.0       # recurrentgemma uses 30.0

    # --- MoE ---
    moe: Optional[MoEConfig] = None
    # --- MLA ---
    mla: Optional[MLAConfig] = None
    # --- DeepSeek multi-token prediction: number of extra MTP heads ---
    mtp_depth: int = 0

    # --- recurrent (rglru / xlstm) ---
    rnn_width: Optional[int] = None  # RG-LRU lru width (None -> d_model)
    conv_width: int = 4              # temporal conv in Griffin block
    # xLSTM: mLSTM up-projection factor; block owns its FFN when d_ff == 0
    mlstm_proj_factor: float = 2.0
    # chunked-remat time scan for mLSTM (0 = off): carries (the per-step
    # matrix memory C) are stored only at chunk boundaries and recomputed
    # within chunks during backward — the §Perf memory hillclimb for
    # xlstm train shapes.
    mlstm_chunk: int = 0

    # --- encoder-decoder (audio) ---
    encoder_layers: int = 0          # >0 => encoder-decoder model
    # --- modality frontend stub: embeddings arrive precomputed ---
    frontend: Optional[str] = None   # None | "audio" | "vision"
    num_prefix_tokens: int = 0       # VLM image-patch tokens per sample

    # --- numerics ---
    dtype: str = "float32"           # activation/param dtype for lowering

    # per-layer activation rematerialization: each block of the stack runs
    # under torch.utils.checkpoint while autograd records (the reference's
    # jax.checkpoint around each block in the scan); no effect under no_grad
    remat: bool = True

    # --- distribution ---
    # ZeRO-3-style FSDP over the data axis. For configs whose params+
    # Adam state exceed HBM with tensor-parallel alone.  Mutually
    # exclusive with using the data axis as an
    # EnFed client axis: fsdp configs federate over the pod axis instead
    # (see DESIGN.md §Arch-applicability).
    fsdp: bool = False

    # ------------------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.num_heads

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def is_encoder_decoder(self) -> bool:
        return self.encoder_layers > 0

    def block_type(self, layer: int) -> str:
        return self.block_pattern[layer % len(self.block_pattern)]

    @property
    def layer_types(self) -> Tuple[str, ...]:
        return tuple(self.block_type(i) for i in range(self.num_layers))

    @property
    def supports_long_decode(self) -> bool:
        """True if decode state is o(seq): recurrent state and/or windowed KV."""
        quad = {"attn", "mla"}
        return all(t not in quad for t in self.layer_types)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # Reduced variant used by CPU smoke tests: same family/pattern, tiny dims.
    def smoke(self) -> "ModelConfig":
        pat = len(self.block_pattern)
        layers = max(2, pat) if pat > 1 else 2
        kw = dict(
            num_layers=layers,
            d_model=128,
            num_heads=4,
            num_kv_heads=min(self.num_kv_heads, 2) or 1,
            head_dim=32,
            d_ff=0 if self.d_ff == 0 else 256,
            vocab_size=512,
            encoder_layers=2 if self.encoder_layers else 0,
            sliding_window=64,
            local_window=64,
            rnn_width=128 if self.rnn_width else None,
            num_prefix_tokens=8 if self.num_prefix_tokens else 0,
            mtp_depth=min(self.mtp_depth, 1),
            dtype="float32",
        )
        if self.moe is not None:
            kw["moe"] = dataclasses.replace(
                self.moe,
                num_experts=min(self.moe.num_experts, 4),
                num_experts_per_tok=min(self.moe.num_experts_per_tok, 2),
                num_shared_experts=min(self.moe.num_shared_experts, 1),
                d_ff_expert=128,
            )
        if self.mla is not None:
            kw["mla"] = MLAConfig(
                q_lora_rank=64, kv_lora_rank=32,
                qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
            )
        return self.replace(**kw)
