"""Logical sharding rules: parameter / activation / cache PartitionSpecs
(the reference's ``sharding/rules.py``; the specs are the port's
``PartitionSpec``, a tuple of axis names, resolved onto a rank mesh by
``sharding.api.resolve``).

Layout (production mesh axes: optional "pod", "data", "model"):
- batch                 -> ("pod","data")   (pure DP; "pod" is extra DP)
- TP ("model")          -> attention heads, MLP hidden, vocab, SSM channels
- FSDP ("data")         -> the non-TP weight axis of every large matrix
- KV-cache sequence dim -> "model"          (decode sequence parallelism)
- MoE experts           -> replicated ("tp" mode, hidden-dim TP inside the
                           experts) or "model" ("ep" mode, when E % tp == 0)

Weights keep heads as separate tensor dims — (D, H, hd) instead of
(D, H*hd) — so head-axis sharding never fragments head_dim (uneven head
counts, e.g. 12 heads over tp=16, split as GSPMD pads them: shards of
``ceil(n / w)``, the last one short; ``sharding.api.shard_spans``).
"""
from __future__ import annotations

from typing import TYPE_CHECKING

from repro_torch.sharding.api import PartitionSpec as P
from repro_torch.tree import tree_map

if TYPE_CHECKING:
    from repro_torch.models.base import ModelConfig

DP_AXES = ("pod", "data")
FSDP = "data"
TP = "model"
EP = "expert"


def legal_tp_widths(cfg: "ModelConfig", max_width: int = 0) -> tuple:
    """Tensor-parallel widths the model reshards to EXACTLY: widths that
    divide both the (padded) head count and d_ff, so every "model"-sharded
    dim splits without GSPMD padding and checkpoint spans re-tile exactly
    across a tp change.  Always contains 1."""
    heads = cfg.effective_num_heads or 1
    dff = cfg.d_ff or heads
    lim = max_width or min(heads, dff)
    return tuple(w for w in range(1, lim + 1)
                 if heads % w == 0 and dff % w == 0)


def legal_dp_widths(cfg: "ModelConfig", max_width: int = 0) -> tuple:
    """Data-parallel (FSDP) widths the params reshard to EXACTLY: every
    FSDP-sharded dim in the spec tables is d_model-sized, so dp must
    divide d_model for ``device_put`` / checkpoint spans to split without
    padding.  Always contains 1."""
    dm = cfg.d_model or 1
    lim = max_width or dm
    return tuple(w for w in range(1, min(dm, lim) + 1) if dm % w == 0)


def batch_spec(ndim_after_batch: int = 1) -> P:
    return P(DP_AXES, *([None] * ndim_after_batch))


def res_spec(cfg: "ModelConfig") -> P:
    """Sharding of residual-stream activations (B,S,D): sequence-parallel
    over "model" when cfg.seq_shard (Megatron SP), else replicated past DP."""
    return P(DP_AXES, TP, None) if cfg.seq_shard else P(DP_AXES, None, None)


def _attn_specs(cfg: "ModelConfig", tp_size: int) -> dict:
    kv_shardable = tp_size == 0 or (cfg.num_kv_heads % max(tp_size, 1) == 0)
    kv = TP if kv_shardable else None
    s = {
        "wq": P(FSDP, TP, None),
        "wk": P(FSDP, kv, None),
        "wv": P(FSDP, kv, None),
        "wo": P(TP, None, FSDP),
    }
    if cfg.qkv_bias:
        s["bq"] = P(TP, None)
        s["bk"] = P(kv, None)
        s["bv"] = P(kv, None)
    return s


def _mlp_specs() -> dict:
    return {"w_in": P(FSDP, TP), "w_gate": P(FSDP, TP), "w_out": P(TP, FSDP)}


def _moe_specs(cfg: "ModelConfig", tp_size: int, ep) -> dict:
    """Expert-weight layout, three modes selected by ``ep``:

    - ``False``: TP inside the experts (hidden dim over "model").
    - ``True`` (legacy 2D): experts over "model" when E % tp == 0 — the
      whole model axis is repurposed as expert parallelism.
    - int >= 1 (3D mesh): experts over the dedicated "expert" axis AND
      hidden dim over "model" simultaneously.  On a mesh without an
      "expert" axis the EP entry filters away (sharding.api._filter_axes),
      degrading to the ``False`` layout — the same specs serve 2D and 3D.
    """
    if isinstance(ep, bool):
        if ep and tp_size and cfg.num_experts % tp_size == 0:
            e, tp = TP, None
        else:
            e, tp = None, TP
    else:
        e, tp = EP, TP
    return {
        "router": P(None, None),
        "w_in": P(e, FSDP, tp),
        "w_gate": P(e, FSDP, tp),
        "w_out": P(e, tp, FSDP),
    }


def _ssm_specs() -> dict:
    return {
        "in_proj": P(FSDP, TP),
        "conv_w": P(None, TP),
        "conv_b": P(TP),
        "x_proj": P(TP, None),
        "dt_w": P(None, TP),
        "dt_b": P(TP),
        "A_log": P(TP, None),
        "D": P(TP),
        "out_proj": P(TP, FSDP),
    }


def _rec_specs() -> dict:
    return {
        "x_proj": P(FSDP, TP),
        "gate_proj": P(FSDP, TP),
        "conv_w": P(None, TP),
        "conv_b": P(TP),
        "w_i": P(FSDP, TP),
        "b_i": P(TP),
        "w_r": P(FSDP, TP),
        "b_r": P(TP),
        "lam": P(TP),
        "out_proj": P(TP, FSDP),
    }


def layer_specs(cfg: "ModelConfig", kind: str, tp_size: int,
                moe_ep=False) -> dict:
    from repro_torch.models.base import BIDIR, FULL, LOCAL, REC, SSM

    if kind in (FULL, LOCAL, BIDIR):
        s: dict = {"ln1": P(None), "ln2": P(None),
                   "attn": _attn_specs(cfg, tp_size)}
        if cfg.sandwich_norm:
            s["ln1_post"] = P(None)
            s["ln2_post"] = P(None)
        if cfg.num_experts:
            s["moe"] = _moe_specs(cfg, tp_size, moe_ep)
        else:
            s["mlp"] = _mlp_specs()
            if cfg.mlp_act not in ("silu", "gelu"):
                s["mlp"].pop("w_gate")
        return s
    if kind == SSM:
        return {"ln": P(None), "ssm": _ssm_specs()}
    if kind == REC:
        return {"ln1": P(None), "ln2": P(None), "rec": _rec_specs(),
                "mlp": _mlp_specs()}
    raise ValueError(kind)


def _prepend(tree, n: int = 1):
    return tree_map(lambda p: P(*([None] * n), *p), tree)


def param_specs(cfg: "ModelConfig", tp_size: int, moe_ep=False) -> dict:
    """PartitionSpec tree matching the train state's parameter tree
    (``models.transformer.init_train_params``: no ``embed`` for
    embedding inputs; stacked blocks, or one entry a layer where the
    layers do not fill whole blocks)."""
    from repro_torch.models.transformer import train_stacked

    specs: dict = {}
    if not cfg.embedding_inputs:
        specs["embed"] = {"tok": P(TP, None)}
    pattern = cfg.pattern
    if train_stacked(cfg):
        specs["blocks"] = {
            f"l{p}": _prepend(layer_specs(cfg, pattern[p], tp_size, moe_ep))
            for p in range(len(pattern))
        }
    else:
        specs["layers"] = {
            f"layer_{i}": layer_specs(cfg, kind, tp_size, moe_ep)
            for i, kind in enumerate(cfg.layer_kinds())
        }
    specs["final_norm"] = P(None)
    if not cfg.tie_embeddings:
        specs["lm_head"] = P(None, TP)
    return specs


def cache_specs(cfg: "ModelConfig", tp_size: int) -> dict:
    """PartitionSpec tree matching the decode cache pytree (see models)."""
    from repro_torch.models.base import BIDIR, FULL, LOCAL, REC, SSM

    def one(kind: str) -> dict:
        if kind in (FULL, LOCAL, BIDIR):
            # KV cache: (B, Sc, K, hd) — sequence dim sharded over model (SP
            # decode); batch over DP.
            return {"k": P(DP_AXES, TP, None, None),
                    "v": P(DP_AXES, TP, None, None),
                    "pos": P(None)}
        if kind == SSM:
            return {"conv": P(DP_AXES, None, TP), "h": P(DP_AXES, TP, None)}
        if kind == REC:
            return {"conv": P(DP_AXES, None, TP), "h": P(DP_AXES, TP)}
        raise ValueError(kind)

    from repro_torch.models.transformer import train_stacked

    if train_stacked(cfg):
        return {"blocks": {f"l{p}": _prepend(one(cfg.pattern[p]))
                           for p in range(len(cfg.pattern))},
                "index": P()}
    return {"layers": {f"layer_{i}": one(kind)
                       for i, kind in enumerate(cfg.layer_kinds())},
            "index": P()}


def state_specs(cfg: "ModelConfig", tp_size: int, moe_ep=False) -> dict:
    """Specs for the full TrainState pytree (params + opt moments + scalars)."""
    ps = param_specs(cfg, tp_size, moe_ep)
    return {
        "step": P(),
        "params": ps,
        "opt": {"m": ps, "v": ps, "count": P()},
        "rng": P(None),
    }
