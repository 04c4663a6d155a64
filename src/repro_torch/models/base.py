"""Model configuration + registry (the port's ``ModelConfig``).

The same frozen dataclass as the reference's, with torch dtypes and the
fields the dense attention, MoE and Mamba-1 paths read.  ``use_pallas``
is gone: the tensor's device decides between a kernel and its plain
version.  The train state stacks homogeneous blocks, as the reference
does with ``scan_layers=True``, wherever the layers fill whole blocks of
the pattern, and keeps one entry a layer otherwise (tiny
recurrentgemma's 5 layers over a pattern of 3, the reference's one
``scan_layers=False`` config; ``transformer.train_stacked``), so that
flag is gone too.
``seq_shard`` is kept for the reference's configs but changes nothing:
on a mesh the port keeps the residual stream whole on every rank of a
``"model"`` group.  ``pad_heads_to`` pads the q heads of each KV group
as the reference does, the padded heads masked to zero, so that weights
and checkpoints keep the reference's shapes.
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
    mrope_sections: Tuple[int, ...] = ()   # qwen2-vl M-RoPE (t, h, w) sections of head_dim/2
    window: int = 0                        # sliding-window size (0 = no SWA anywhere)
    pattern: Tuple[str, ...] = (FULL,)     # repeating per-layer kinds
    attn_softcap: float = 0.0              # attention-logit soft capping
    final_softcap: float = 0.0             # final-logit soft capping
    query_scale: float = 0.0               # 0 => 1/sqrt(head_dim)
    # --- mlp ---
    mlp_act: str = "silu"                  # silu (SwiGLU) | gelu (GeGLU) | gelu_plain
    # --- MoE ---
    num_experts: int = 0
    experts_per_token: int = 0
    capacity_factor: float = 1.25
    dead_experts: Tuple[int, ...] = ()    # expert ids lost to failures:
                                          # masked out of routing, capacity
                                          # computed from the live count
    # --- SSM (mamba-1) ---
    ssm_state: int = 0
    conv_width: int = 4
    expand: int = 2
    dt_rank: int = 0                       # 0 => ceil(d_model / 16)
    # --- hybrid (RG-LRU) ---
    lru_width: int = 0
    # --- embeddings / head ---
    embedding_inputs: bool = False         # vlm/audio: input is precomputed embeddings
    tie_embeddings: bool = True
    embed_scale: bool = False              # gemma-style sqrt(d_model) embed scaling
    sandwich_norm: bool = False            # gemma2 post-attn/post-mlp norms
    norm_eps: float = 1e-6
    # --- execution ---
    pad_heads_to: int = 0                  # pad q-heads per KV group (masked pad)
    seq_shard: bool = False                # the reference's Megatron SP flag
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
    def effective_num_heads(self) -> int:
        """q-head count after padding (``pad_heads_to``, the reference's
        even TP sharding): real heads sit in the first ``num_heads /
        num_kv_heads`` slots of each KV group, padded slots are masked to
        zero (``transformer._head_mask``), so the math equals the unpadded
        model's."""
        if self.pad_heads_to and self.pad_heads_to > self.num_heads:
            if self.pad_heads_to % max(self.num_kv_heads, 1):
                raise ValueError(f"{self.name}: pad_heads_to "
                                 f"{self.pad_heads_to} is not a multiple of "
                                 f"{self.num_kv_heads} KV heads")
            return self.pad_heads_to
        return self.num_heads

    @property
    def live_experts(self) -> int:
        """Expert count still routable after failures (degraded MoE)."""
        return self.num_experts - len(self.dead_experts)

    @property
    def resolved_dt_rank(self) -> int:
        return self.dt_rank or -(-self.d_model // 16)

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def is_causal(self) -> bool:
        return BIDIR not in self.pattern

    @property
    def has_decode(self) -> bool:
        return self.is_causal

    @property
    def subquadratic(self) -> bool:
        """True if no layer needs an unbounded full-attention KV cache."""
        return all(k in (SSM, REC) for k in self.pattern) or (
            FULL not in self.pattern and BIDIR not in self.pattern
        )

    def layer_kinds(self) -> Tuple[str, ...]:
        """Per-layer kinds, pattern repeated/truncated to num_layers."""
        reps = -(-self.num_layers // len(self.pattern))
        return tuple((self.pattern * reps)[: self.num_layers])

    def num_params(self) -> int:
        """Analytic parameter count, the reference's formula (unpadded
        heads, no embed table for embedding inputs)."""
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        hd = self.resolved_head_dim
        h, k = self.num_heads, self.num_kv_heads
        n = 0 if self.embedding_inputs else v * d
        if not self.tie_embeddings:
            n += v * d
        for kind in self.layer_kinds():
            if kind in (FULL, LOCAL, BIDIR):
                n += d * h * hd + 2 * d * k * hd + h * hd * d   # q,k,v,o
                if self.qkv_bias:
                    n += (h + 2 * k) * hd
                n += 2 * d                                      # ln1, ln2
                if self.sandwich_norm:
                    n += 2 * d
                if self.num_experts:
                    n += d * self.num_experts
                    n += self.num_experts * (2 * d * f + f * d)
                else:
                    gated = self.mlp_act in ("silu", "gelu")
                    n += (2 * d * f if gated else d * f) + f * d
            elif kind == SSM:
                di, ns = self.d_inner, self.ssm_state
                dtr = self.resolved_dt_rank
                n += d * 2 * di                                  # in_proj
                n += self.conv_width * di + di                   # conv + bias
                n += di * (dtr + 2 * ns)                         # x_proj
                n += dtr * di + di                               # dt_proj
                n += di * ns + di                                # A_log, D
                n += di * d                                      # out_proj
                n += d                                           # norm
            elif kind == REC:
                w = self.lru_width or d
                n += d * 2 * w                                   # x_proj, gate_proj
                n += self.conv_width * w + w                     # conv
                n += 3 * w                                       # lam, b_i, b_r
                n += 2 * w * w                                   # w_i, w_r
                n += w * d                                       # out_proj
                n += 2 * d                                       # norms
                gated = self.mlp_act in ("silu", "gelu")
                n += (2 * d * f if gated else d * f) + f * d
        n += d                                                   # final norm
        return n

    def num_active_params(self) -> int:
        """Active params per token (MoE: only top-k experts)."""
        if not self.num_experts:
            return self.num_params()
        d, f = self.d_model, self.d_ff
        per_layer_moe = self.num_experts * (2 * d * f + f * d)
        active_moe = self.experts_per_token * (2 * d * f + f * d)
        n_attn = sum(1 for k in self.layer_kinds()
                     if k in (FULL, LOCAL, BIDIR))
        return self.num_params() - n_attn * (per_layer_moe - active_moe)


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
