"""The dense decoder stack, PyTorch port of the reference's
``models/transformer.py`` FULL/LOCAL attention path: GQA, sliding window,
attention and final logit soft-caps, tied or untied embeddings, padded
vocab.  A Python loop over layers replaces the reference's ``scan``; the
sharding constraints have no counterpart on one card and are dropped.

Modes of ``forward``:
  ``train``        — logits for every position from the train state's
                     parameters (``init_train_params``: float32 master
                     weights, blocks stacked as the reference stacks them
                     for ``scan``), cast to the compute dtype inside the
                     autograd graph on every call; each block is
                     recomputed in the backward.
  ``prefill``      — logits for every position; with ``cache`` (a fresh
                     row from ``init_cache``) the row's k/v/pos are filled
                     in place.
  ``paged_decode`` — one token per request against the shared page pool
                     (``init_paged_cache``) through per-request page
                     tables; this step's k/v land in the pool in place.
The ``decode`` mode over contiguous cache rows waits for the slot-pool
slice.

Parameters are plain nested dicts of tensors: ``{"embed": {"tok"},
"layers": [{"ln1", "attn": {"wq","wk","wv","wo"[,"bq","bk","bv"]},
"ln2", "mlp": {...}}, ...], "final_norm"[, "lm_head"]}``, cast to the
compute dtype once at load.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.paged_attention.ops import paged_decode_attention
from repro_torch.layers.mlp import mlp_apply, mlp_init
from repro_torch.layers.norms import rms_norm
from repro_torch.layers.rope import apply_rope, make_positions
from repro_torch.models.base import BIDIR, FULL, LOCAL, ModelConfig
from repro_torch.tree import flatten_named, unflatten

Params = Dict[str, Any]


def _check_kinds(cfg: ModelConfig) -> None:
    bad = sorted({k for k in cfg.layer_kinds()
                  if k not in (FULL, LOCAL, BIDIR)})
    if bad:
        raise NotImplementedError(
            f"{cfg.name} has {bad} layers; the port runs attention stacks "
            "only (SSM/REC wait for the model-families slice, ROADMAP)")


# --------------------------------------------------------------------------
# init / load
# --------------------------------------------------------------------------

def load_weight(cfg: ModelConfig, w: torch.Tensor) -> torch.Tensor:
    """The reference casts float32 weights to the compute dtype on every
    forward (``_cast_params``); the port does the same cast once, at
    load — the same arithmetic without per-forward copies of the
    weights."""
    if w.dtype == torch.float32 and cfg.dtype != torch.float32:
        return w.to(cfg.dtype)
    return w


def init_params(cfg: ModelConfig, *, seed: int, device=None) -> Params:
    """Random weights from a ``torch.Generator`` seeded with ``seed`` on
    the target device (``None`` = the card).  Same shapes and scales as
    the reference's ``init_params``; the numbers differ from
    ``jax.random``'s.  Each weight is drawn in ``cfg.param_dtype`` and
    cast to the compute dtype right away, so the full-precision copy of
    the model never exists at once."""
    _check_kinds(cfg)
    device = resolve_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))

    def normal(shape, std):
        w = torch.randn(shape, generator=gen, device=device,
                        dtype=torch.float32) * std
        return load_weight(cfg, w.to(cfg.param_dtype))

    def ones(n):
        return load_weight(cfg, torch.ones(n, device=device,
                                           dtype=cfg.param_dtype))

    def zeros(*shape):
        return load_weight(cfg, torch.zeros(shape, device=device,
                                            dtype=cfg.param_dtype))

    d, hd = cfg.d_model, cfg.resolved_head_dim
    h, kv = cfg.num_heads, cfg.num_kv_heads
    params: Params = {"embed": {"tok": normal((cfg.padded_vocab, d),
                                              d ** -0.5)}}
    layers: List[Params] = []
    for _ in range(cfg.num_layers):
        attn = {"wq": normal((d, h, hd), d ** -0.5),
                "wk": normal((d, kv, hd), d ** -0.5),
                "wv": normal((d, kv, hd), d ** -0.5),
                "wo": normal((h, hd, d), (h * hd) ** -0.5)}
        if cfg.qkv_bias:
            attn.update(bq=zeros(h, hd), bk=zeros(kv, hd), bv=zeros(kv, hd))
        layer = {"ln1": ones(d), "attn": attn, "ln2": ones(d),
                 "mlp": mlp_init(normal, d, cfg.d_ff, cfg.mlp_act)}
        if cfg.sandwich_norm:
            layer.update(ln1_post=ones(d), ln2_post=ones(d))
        layers.append(layer)
    params["layers"] = layers
    params["final_norm"] = ones(d)
    if not cfg.tie_embeddings:
        params["lm_head"] = normal((d, cfg.padded_vocab), d ** -0.5)
    return params


def init_train_params(cfg: ModelConfig, *, seed: int, device=None) -> Params:
    """The train state's parameters: ``cfg.param_dtype`` (float32) master
    weights from a ``torch.Generator`` seeded with ``seed``, in the
    reference's stacked layout ``{"embed": {"tok"}, "blocks": {"l<p>":
    {...}}, "final_norm"[, "lm_head"]}`` where every block leaf has a
    leading axis of ``num_layers / len(pattern)`` (layer ``g * len(pattern)
    + p``).  Same shapes and scales as the reference's ``init_params``."""
    _check_kinds(cfg)
    device = resolve_device(device)
    P_ = len(cfg.pattern)
    if cfg.num_layers % P_:
        raise ValueError(f"{cfg.name}: {cfg.num_layers} layers do not "
                         f"stack into blocks of {P_}")
    G = cfg.num_layers // P_
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    pd = cfg.param_dtype

    def normal(shape, std):
        return (torch.randn(tuple(shape), generator=gen, device=device,
                            dtype=torch.float32) * std).to(pd)

    def stacked(shape, std):
        return normal((G,) + tuple(shape), std)

    def ones(*shape):
        return torch.ones(shape, device=device, dtype=pd)

    d, hd = cfg.d_model, cfg.resolved_head_dim
    h, kv = cfg.num_heads, cfg.num_kv_heads
    params: Params = {"embed": {"tok": normal((cfg.padded_vocab, d),
                                              d ** -0.5)}}
    blocks = {}
    for p in range(P_):
        attn = {"wq": stacked((d, h, hd), d ** -0.5),
                "wk": stacked((d, kv, hd), d ** -0.5),
                "wv": stacked((d, kv, hd), d ** -0.5),
                "wo": stacked((h, hd, d), (h * hd) ** -0.5)}
        if cfg.qkv_bias:
            attn.update(bq=torch.zeros(G, h, hd, device=device, dtype=pd),
                        bk=torch.zeros(G, kv, hd, device=device, dtype=pd),
                        bv=torch.zeros(G, kv, hd, device=device, dtype=pd))
        blk = {"ln1": ones(G, d), "attn": attn, "ln2": ones(G, d),
               "mlp": mlp_init(stacked, d, cfg.d_ff, cfg.mlp_act)}
        if cfg.sandwich_norm:
            blk.update(ln1_post=ones(G, d), ln2_post=ones(G, d))
        blocks[f"l{p}"] = blk
    params["blocks"] = blocks
    params["final_norm"] = ones(d)
    if not cfg.tie_embeddings:
        params["lm_head"] = normal((d, cfg.padded_vocab), d ** -0.5)
    return params


# --------------------------------------------------------------------------
# caches
# --------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, cache_len: int,
               device) -> Dict[str, Any]:
    """Fresh contiguous cache rows for prefill: per layer k/v
    (batch, sc, K, hd) and ``pos`` (sc,) = -1 (empty).  LOCAL layers keep
    a rolling window of ``min(cache_len, window)`` slots."""
    kv, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    layers = []
    for kind in cfg.layer_kinds():
        sc = (min(cache_len, cfg.window) if kind == LOCAL and cfg.window
              else cache_len)
        layers.append({
            "k": torch.zeros(batch, sc, kv, hd, dtype=cfg.dtype,
                             device=device),
            "v": torch.zeros(batch, sc, kv, hd, dtype=cfg.dtype,
                             device=device),
            "pos": torch.full((sc,), -1, dtype=torch.int32, device=device)})
    return {"layers": layers}


def init_paged_cache(cfg: ModelConfig, num_pages: int, page_size: int,
                     device) -> Dict[str, torch.Tensor]:
    """Block-paged KV pool (serve/page_table.py): ``num_pages`` pages of
    ``page_size`` tokens per attention layer, stacked over layers as
    k/v (L, P, ps, K, hd).  Page 0 is the reserved null page."""
    bad = sorted({k for k in cfg.layer_kinds() if k not in (FULL, LOCAL)})
    if bad:
        raise ValueError(f"paged KV cache needs an attention-only decode "
                         f"stack; {cfg.name} has {bad} layers")
    shape = (cfg.num_layers, num_pages, page_size, cfg.num_kv_heads,
             cfg.resolved_head_dim)
    return {"k": torch.zeros(shape, dtype=cfg.dtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=device)}


def _fill_cache(entry: Dict[str, torch.Tensor], k: torch.Tensor,
                v: torch.Tensor, n: int) -> None:
    """Write the first ``n`` positions' k/v into a fresh cache row."""
    sc = entry["k"].shape[1]
    if sc >= n:
        entry["k"][:, :n] = k[:, :n]
        entry["v"][:, :n] = v[:, :n]
        entry["pos"][:n] = torch.arange(n, dtype=torch.int32,
                                        device=k.device)
    else:                                        # rolling window cache
        tail = torch.arange(n - sc, n, device=k.device)
        slots = tail % sc
        entry["k"][:, slots] = k[:, n - sc:n]
        entry["v"][:, slots] = v[:, n - sc:n]
        entry["pos"][slots] = tail.to(torch.int32)


# --------------------------------------------------------------------------
# layer application
# --------------------------------------------------------------------------

def _project(h: torch.Tensor, w: torch.Tensor,
             bias: Optional[torch.Tensor]) -> torch.Tensor:
    d, nh, hd = w.shape
    y = (h @ w.reshape(d, nh * hd)).reshape(h.shape[:-1] + (nh, hd))
    if bias is not None:
        y = y + bias
    return y


def _attn_apply(p: Params, x: torch.Tensor, kind: str, cfg: ModelConfig,
                positions: torch.Tensor, *, entry=None, n_valid: int = 0,
                pages=None, layer: int = 0, paged=None) -> torch.Tensor:
    a = p["attn"]
    B, S, _ = x.shape
    scale = cfg.query_scale or None
    window = cfg.window if kind == LOCAL else 0

    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    q = _project(h, a["wq"], a.get("bq"))
    k = _project(h, a["wk"], a.get("bk"))
    v = _project(h, a["wv"], a.get("bv"))
    if kind != BIDIR or cfg.rope_theta > 0:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)

    if paged is not None:                                  # paged decode
        page_tables, lengths, (pidx, off) = paged
        kp, vp = pages["k"][layer], pages["v"][layer]
        # this step's k/v land at logical position lengths[r], in place;
        # inactive rows (zeroed table, length 0) write the null page 0,
        # which the length mask keeps out of every real request's softmax
        kp[pidx, off] = k[:, 0]
        vp[pidx, off] = v[:, 0]
        o = paged_decode_attention(q, kp, vp, page_tables, lengths,
                                   window=window, softcap=cfg.attn_softcap,
                                   scale=scale)
    else:
        o = flash_attention(q, k, v, causal=(kind != BIDIR), window=window,
                            softcap=cfg.attn_softcap, scale=scale)
        if entry is not None:                            # prefill fills cache
            _fill_cache(entry, k, v, n_valid)

    H, hd, d = a["wo"].shape
    o = o.reshape(B, S, H * hd) @ a["wo"].reshape(H * hd, d)
    if cfg.sandwich_norm:
        o = rms_norm(o, p["ln1_post"], cfg.norm_eps)
    x = x + o
    h2 = rms_norm(x, p["ln2"], cfg.norm_eps)
    m = mlp_apply(p["mlp"], h2, cfg.mlp_act)
    if cfg.sandwich_norm:
        m = rms_norm(m, p["ln2_post"], cfg.norm_eps)
    return x + m


# --------------------------------------------------------------------------
# full model
# --------------------------------------------------------------------------

def _logits_out(cfg: ModelConfig, params: Params,
                x: torch.Tensor) -> torch.Tensor:
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    if cfg.tie_embeddings:
        logits = F.linear(x, params["embed"]["tok"])
    else:
        logits = x @ params["lm_head"]
    if cfg.final_softcap:
        logits = torch.tanh(logits / cfg.final_softcap) * cfg.final_softcap
    return logits


def _train_weights(cfg: ModelConfig,
                   params: Params) -> Tuple[Params, List[Params]]:
    """The reference's ``_cast_params`` for the train layout: float32
    master weights cast to the compute dtype inside the autograd graph
    (so their gradients come back in float32), then each stacked block
    leaf unbound into per-layer views (one stack in the backward)."""
    cd = cfg.dtype

    def cast(w):
        if w.dtype == torch.float32 and cd != torch.float32:
            return w.to(cd)
        return w

    P_ = len(cfg.pattern)
    G = cfg.num_layers // P_
    layers: List[Params] = [None] * cfg.num_layers
    for p in range(P_):
        blk = params["blocks"][f"l{p}"]
        parts = [cast(w).unbind(0) for _, w in flatten_named(blk)]
        for g in range(G):
            layers[g * P_ + p] = unflatten(blk, [pt[g] for pt in parts])
    top: Params = {"embed": {"tok": cast(params["embed"]["tok"])},
                   "final_norm": cast(params["final_norm"])}
    if "lm_head" in params:
        top["lm_head"] = cast(params["lm_head"])
    return top, layers


def _train_block(x, layers, kinds, cfg, positions):
    for p, kind in zip(layers, kinds):
        x = _attn_apply(p, x, kind, cfg, positions)
    return x


def _forward_train(cfg: ModelConfig, params: Params,
                   batch: Dict[str, Any]) -> torch.Tensor:
    top, layers = _train_weights(cfg, params)
    tokens = batch["tokens"]
    B, S = tokens.shape
    x = F.embedding(tokens.long(), top["embed"]["tok"])
    if cfg.embed_scale:
        x = x * torch.full((), cfg.d_model ** 0.5, dtype=x.dtype,
                           device=x.device)
    positions = make_positions(B, S, device=tokens.device)
    kinds = cfg.layer_kinds()
    P_ = len(cfg.pattern)
    # one recomputed unit per stacked block (the reference checkpoints its
    # scan body): only each block's input is kept for the backward
    for g in range(0, cfg.num_layers, P_):
        x = checkpoint(_train_block, x, layers[g:g + P_], kinds[g:g + P_],
                       cfg, positions, use_reentrant=False)
    return _logits_out(cfg, top, x)


def forward(cfg: ModelConfig, params: Params, batch: Dict[str, Any], *,
            mode: str = "prefill", cache=None):
    """Returns (logits, cache); the cache is updated in place.

    batch: ``tokens`` (B, S).  ``train`` takes the train state's
    parameters (``init_train_params``) and returns (logits, None).  ``prefill`` may carry ``length``: only the
    first ``length`` positions are real (the rest is padding past them,
    which causal attention keeps out of every real position) and only
    those enter the cache.  ``paged_decode`` carries ``lengths`` (R,)
    int32, each row's query position, and ``page_tables`` (R, MPR)
    int32."""
    _check_kinds(cfg)
    if mode == "train":
        return _forward_train(cfg, params, batch), None
    tokens = batch["tokens"]
    B, S = tokens.shape
    x = params["embed"]["tok"][tokens.long()]
    if cfg.embed_scale:
        x = x * torch.full((), cfg.d_model ** 0.5, dtype=x.dtype,
                           device=x.device)
    paged = None
    if mode == "paged_decode":
        if S != 1 or cache is None:
            raise ValueError("paged_decode takes (R, 1) tokens and the pool")
        lengths = batch["lengths"]
        page_tables = batch["page_tables"]
        positions = lengths.long()[:, None]                   # (R, 1)
        ps = cache["k"].shape[2]
        rows = torch.arange(B, device=tokens.device)
        pidx = page_tables.long()[rows, positions[:, 0] // ps]
        paged = (page_tables, lengths, (pidx, positions[:, 0] % ps))
    elif mode == "prefill":
        positions = make_positions(B, S, device=tokens.device)
    else:
        raise ValueError(f"mode {mode!r}: the port runs train, prefill and "
                         "paged_decode (decode waits for the slot-pool "
                         "slice)")
    n_valid = int(batch.get("length", S))
    for i, kind in enumerate(cfg.layer_kinds()):
        entry = (cache["layers"][i]
                 if mode == "prefill" and cache is not None else None)
        x = _attn_apply(params["layers"][i], x, kind, cfg, positions,
                        entry=entry, n_valid=n_valid,
                        pages=cache if paged is not None else None,
                        layer=i, paged=paged)
    return _logits_out(cfg, params, x), cache
