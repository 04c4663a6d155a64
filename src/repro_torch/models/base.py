"""Model configuration + registry (the port's ``ModelConfig``).

The same frozen dataclass as the reference's, with torch dtypes and the
fields the dense attention path reads.  ``use_pallas`` is gone: the
tensor's device decides between a kernel and its plain version.  The
train state always stacks homogeneous blocks, as the reference does with
``scan_layers=True``, so that flag is gone too.  The MoE, SSM and RG-LRU
fields wait for their slices.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import torch

# Layer kinds used in block patterns.
FULL = "full"          # full (global) causal attention
LOCAL = "local"        # sliding-window attention
BIDIR = "bidir"        # bidirectional full attention (encoder)
REC = "rec"            # RG-LRU recurrent block
SSM = "ssm"            # Mamba-1 selective-SSM block


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int = 0
    num_kv_heads: int = 0
    head_dim: int = 0
    d_ff: int = 0
    vocab_size: int = 32000
    # --- attention features ---
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    window: int = 0                        # sliding-window size (0 = no SWA anywhere)
    pattern: Tuple[str, ...] = (FULL,)     # repeating per-layer kinds
    attn_softcap: float = 0.0              # attention-logit soft capping
    final_softcap: float = 0.0             # final-logit soft capping
    query_scale: float = 0.0               # 0 => 1/sqrt(head_dim)
    # --- mlp ---
    mlp_act: str = "silu"                  # silu (SwiGLU) | gelu (GeGLU) | gelu_plain
    # --- embeddings / head ---
    tie_embeddings: bool = True
    embed_scale: bool = False              # gemma-style sqrt(d_model) embed scaling
    sandwich_norm: bool = False            # gemma2 post-attn/post-mlp norms
    norm_eps: float = 1e-6
    # --- execution ---
    param_dtype: Any = torch.float32
    dtype: Any = torch.bfloat16

    # ----- derived -----
    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a multiple of 2048 (128 for small vocabs), the
        reference's layout: weights carried across keep their shape."""
        mult = 2048 if self.vocab_size > 2048 else 128
        return -(-self.vocab_size // mult) * mult

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // max(self.num_heads, 1))

    @property
    def is_causal(self) -> bool:
        return BIDIR not in self.pattern

    @property
    def has_decode(self) -> bool:
        return self.is_causal

    def layer_kinds(self) -> Tuple[str, ...]:
        """Per-layer kinds, pattern repeated/truncated to num_layers."""
        reps = -(-self.num_layers // len(self.pattern))
        return tuple((self.pattern * reps)[: self.num_layers])


_REGISTRY: dict = {}


def register(name: str, full: ModelConfig, tiny: ModelConfig) -> None:
    _REGISTRY[name] = (full, tiny)


def get_config(name: str, tiny: bool = False) -> ModelConfig:
    import repro_torch.configs  # noqa: F401  (populates the registry)

    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name][1 if tiny else 0]


def list_archs() -> Tuple[str, ...]:
    import repro_torch.configs  # noqa: F401

    return tuple(sorted(_REGISTRY))
