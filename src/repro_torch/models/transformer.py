"""The model stack, PyTorch port of the reference's
``models/transformer.py``: FULL/LOCAL/BIDIR attention layers (GQA/MQA,
q heads padded per KV group and masked, RoPE or M-RoPE, sliding window,
attention and final logit soft-caps, tied or untied embeddings, padded
vocab, token or embedding inputs, top-k MoE feed-forward blocks with
degraded experts), Mamba-1 SSM layers (``models/mamba.py``) and RG-LRU
layers (``models/rglru.py``).  A Python loop over layers
replaces the reference's ``scan``; the sharding constraints have no
counterpart on one card.  On a mesh, ``train/mesh_step.py`` runs the
train mode over each rank's shards through ``par`` (Megatron column and
row parallel projections, experts over ``"expert"``).

Modes of ``forward``:
  ``train``        — logits for every position and the MoE aux loss
                     (summed over layers; zero for a dense stack) from
                     the train state's
                     parameters (``init_train_params``: float32 master
                     weights, blocks stacked as the reference stacks them
                     for ``scan``, or one entry a layer where the layers
                     do not fill whole blocks), cast to the compute dtype
                     inside the autograd graph on every call; each block
                     of a pattern of 1 or 2 layers, else each layer, is
                     recomputed in the backward (the reference's
                     checkpoints).  ``impl="abft"`` routes
                     the q/k/v/o and MLP projections through the
                     checksummed matmul (SDC tier 1); the attention core
                     stays on the flash kernel (attention layers; an SSM
                     layer's projections stay plain matmuls).
  ``prefill``      — logits for every position; with ``cache`` (a fresh
                     row from ``init_cache``) the row's k/v/pos, or an SSM
                     or RG-LRU layer's conv and recurrent state, are
                     filled in place.  An encoder (BIDIR) runs this mode
                     without a cache.
  ``decode``       — one token per cache row against contiguous rows
                     (the slot pool, ``serve/cache_pool.py``, or a
                     lockstep batch cache), the state advanced in place:
                     each row at its own position (``cache["index"]``).
  ``paged_decode`` — one token per request against the shared page pool
                     (``init_paged_cache``) through per-request page
                     tables; this step's k/v land in the pool in place.
                     Attention stacks only.

Parameters are plain nested dicts of tensors: ``{["embed": {"tok"},]
"layers": [...], "final_norm"[, "lm_head"]}`` (no ``embed`` for embedding
inputs) with an attention layer
``{"ln1", "attn": {"wq","wk","wv","wo"[,"bq","bk","bv"]}, "ln2", "mlp":
{...}}`` (an MoE stack: ``"moe": {"router","w_in","w_gate","w_out"}``
in place of ``"mlp"``), an SSM layer ``{"ln", "ssm": {...}}`` and an
RG-LRU layer ``{"ln1", "rec": {...}, "ln2", "mlp"}``, cast to the compute
dtype once at load except the recurrence leaves ``A_log``, ``D`` and
``lam``, which stay float32 (the reference's ``_KEEP_FP32``).  With
``pad_heads_to``, ``wq``/``bq``/``wo`` keep the padded head count and the
padded heads' outputs are masked to zero (``_head_mask``), as in the
reference, so weights cross between the packages as they are.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.kernels.paged_attention.ops import (paged_decode_attention,
                                                     row_decode_attention,
                                                     row_page_table)
from repro_torch.layers.mlp import _act, dot, mlp_apply, mlp_init
from repro_torch.layers.moe import moe_apply, moe_init
from repro_torch.layers.norms import rms_norm
from repro_torch.layers.rope import apply_mrope, apply_rope, make_positions
from repro_torch.models.base import (BIDIR, FULL, LOCAL, REC, SSM,
                                     ModelConfig)
from repro_torch.models.mamba import ssm_apply, ssm_cache_init, ssm_init
from repro_torch.models.rglru import rec_apply, rec_cache_init, rec_init
from repro_torch.tree import flatten_named, unflatten

Params = Dict[str, Any]


# Recurrence-dynamics leaves stay float32 (exp() of these is sensitive).
_KEEP_FP32 = ("A_log", "D", "lam")


def _check_kinds(cfg: ModelConfig) -> None:
    bad = sorted({k for k in cfg.layer_kinds()
                  if k not in (FULL, LOCAL, BIDIR, SSM, REC)})
    if bad:
        raise ValueError(f"{cfg.name}: unknown layer kinds {bad}")


# --------------------------------------------------------------------------
# init / load
# --------------------------------------------------------------------------

def load_weight(cfg: ModelConfig, w: torch.Tensor,
                name: str = "") -> torch.Tensor:
    """The reference casts float32 weights to the compute dtype on every
    forward (``_cast_params``); the port does the same cast once, at
    load — the same arithmetic without per-forward copies of the
    weights.  Leaves named in ``_KEEP_FP32`` stay float32, as there."""
    if (w.dtype == torch.float32 and cfg.dtype != torch.float32
            and name not in _KEEP_FP32):
        return w.to(cfg.dtype)
    return w


def _layer_init(cfg: ModelConfig, kind: str, normal, ones, zeros,
                const) -> Params:
    """One layer's weights, the reference's shapes and scales, through the
    caller's initialisers: ``normal(shape, std)``, ``ones(*shape)``,
    ``zeros(*shape)`` and ``const(name, tensor)`` (a stacked train block's
    add its leading layer axis)."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    h, kv = cfg.effective_num_heads, cfg.num_kv_heads
    if kind == SSM:
        return {"ln": ones(d), "ssm": ssm_init(cfg, normal, const)}
    if kind == REC:
        return rec_init(cfg, normal, ones, zeros, const)
    attn = {"wq": normal((d, h, hd), d ** -0.5),
            "wk": normal((d, kv, hd), d ** -0.5),
            "wv": normal((d, kv, hd), d ** -0.5),
            "wo": normal((h, hd, d), (h * hd) ** -0.5)}
    if cfg.qkv_bias:
        attn.update(bq=zeros(h, hd), bk=zeros(kv, hd), bv=zeros(kv, hd))
    layer = {"ln1": ones(d), "attn": attn, "ln2": ones(d)}
    if cfg.num_experts:
        layer["moe"] = moe_init(normal, d, cfg.d_ff, cfg.num_experts)
    else:
        layer["mlp"] = mlp_init(normal, d, cfg.d_ff, cfg.mlp_act)
    if cfg.sandwich_norm:
        layer.update(ln1_post=ones(d), ln2_post=ones(d))
    return layer


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

    def ones(*shape):
        return load_weight(cfg, torch.ones(shape, device=device,
                                           dtype=cfg.param_dtype))

    def zeros(*shape):
        return load_weight(cfg, torch.zeros(shape, device=device,
                                            dtype=cfg.param_dtype))

    def const(name, w):
        return load_weight(cfg, w.to(device=device, dtype=cfg.param_dtype),
                           name)

    d = cfg.d_model
    params: Params = {}
    if not cfg.embedding_inputs:
        params["embed"] = {"tok": normal((cfg.padded_vocab, d), d ** -0.5)}
    params["layers"] = [_layer_init(cfg, kind, normal, ones, zeros, const)
                        for kind in cfg.layer_kinds()]
    params["final_norm"] = ones(d)
    if not cfg.tie_embeddings:
        params["lm_head"] = normal((d, cfg.padded_vocab), d ** -0.5)
    return params


def train_stacked(cfg: ModelConfig) -> bool:
    """Whether the train state stacks its layers into blocks of the
    pattern (the reference's ``scan_layers``): every registered config
    whose layers fill whole blocks does; tiny recurrentgemma's 5 layers
    over a pattern of 3 are one entry a layer, as the reference keeps
    them (as are no layers at all: the roofline's probe at L = 0)."""
    return cfg.num_layers > 0 and cfg.num_layers % len(cfg.pattern) == 0


def init_train_params(cfg: ModelConfig, *, seed: int, device=None) -> Params:
    """The train state's parameters: ``cfg.param_dtype`` (float32) master
    weights from a ``torch.Generator`` seeded with ``seed``, in the
    reference's layout: ``{["embed": {"tok"},] "blocks": {"l<p>": {...}},
    "final_norm"[, "lm_head"]}`` where every block leaf has a leading axis
    of ``num_layers / len(pattern)`` (layer ``g * len(pattern) + p``), or
    ``"layers": {"layer_<i>": {...}}`` in place of ``"blocks"`` where the
    layers do not fill whole blocks (``train_stacked``).  No ``embed`` for
    embedding inputs; padded q heads keep their padded shapes.  Same
    shapes and scales as the reference's ``init_params``.
    ``device="meta"`` gives the shapes and dtypes alone."""
    _check_kinds(cfg)
    device = resolve_device(device)
    # on the "meta" device (shapes and dtypes only, the port's
    # ``jax.eval_shape``) nothing is drawn
    gen = None
    if device.type != "meta":
        gen = torch.Generator(device=device)
        gen.manual_seed(int(seed))
    pd = cfg.param_dtype

    def initialisers(lead):
        def normal(shape, std):
            return (torch.randn(lead + tuple(shape), generator=gen,
                                device=device, dtype=torch.float32)
                    * std).to(pd)

        def ones(*shape):
            return torch.ones(lead + shape, device=device, dtype=pd)

        def zeros(*shape):
            return torch.zeros(lead + shape, device=device, dtype=pd)

        def const(name, w):
            return w.to(device=device, dtype=pd).expand(
                lead + tuple(w.shape)).contiguous()

        return normal, ones, zeros, const

    d = cfg.d_model
    plain = initialisers(())
    normal, ones = plain[:2]
    params: Params = {}
    if not cfg.embedding_inputs:
        params["embed"] = {"tok": normal((cfg.padded_vocab, d), d ** -0.5)}
    if train_stacked(cfg):
        stacked = initialisers((cfg.num_layers // len(cfg.pattern),))
        params["blocks"] = {f"l{p}": _layer_init(cfg, kind, *stacked)
                            for p, kind in enumerate(cfg.pattern)}
    else:
        params["layers"] = {f"layer_{i}": _layer_init(cfg, kind, *plain)
                            for i, kind in enumerate(cfg.layer_kinds())}
    params["final_norm"] = ones(d)
    if not cfg.tie_embeddings:
        params["lm_head"] = normal((d, cfg.padded_vocab), d ** -0.5)
    return params


# --------------------------------------------------------------------------
# caches
# --------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, cache_len: int,
               device) -> Dict[str, Any]:
    """Fresh contiguous cache rows: per attention layer k/v
    (batch, sc, K, hd) and ``pos`` (batch, sc) = -1 (empty), LOCAL layers
    with a rolling window of ``min(cache_len, window)`` slots; per SSM
    layer the conv state (batch, W-1, Di) in the compute dtype and the
    scan state ``h`` (batch, Di, N) float32, zero; per RG-LRU layer the
    conv state (batch, W-1, w) and ``h`` (batch, w) float32.  ``index``
    (batch,) int32 is each row's next position (the reference's
    ``cache["index"]``, one a row as under its vmap over slots);
    ``cache_len`` is kept beside it (a rolling layer's rows are
    shorter)."""
    kv, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    layers = []
    for kind in cfg.layer_kinds():
        if kind == SSM:
            layers.append(ssm_cache_init(cfg, batch, device))
            continue
        if kind == REC:
            layers.append(rec_cache_init(cfg, batch, device))
            continue
        sc = (min(cache_len, cfg.window) if kind == LOCAL and cfg.window
              else cache_len)
        layers.append({
            "k": torch.zeros(batch, sc, kv, hd, dtype=cfg.dtype,
                             device=device),
            "v": torch.zeros(batch, sc, kv, hd, dtype=cfg.dtype,
                             device=device),
            "pos": torch.full((batch, sc), -1, dtype=torch.int32,
                              device=device)})
    return {"layers": layers,
            "index": torch.zeros(batch, dtype=torch.int32, device=device),
            "cache_len": cache_len}


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
    """Write the first ``n`` positions' k/v into fresh cache rows (``n``
    is the prompt's real length, never the padded one)."""
    sc = entry["k"].shape[1]
    if sc >= n:
        entry["k"][:, :n] = k[:, :n]
        entry["v"][:, :n] = v[:, :n]
        entry["pos"][:, :n] = torch.arange(n, dtype=torch.int32,
                                           device=k.device)
    else:                                        # rolling window cache
        tail = torch.arange(n - sc, n, device=k.device)
        slots = tail % sc
        entry["k"][:, slots] = k[:, n - sc:n]
        entry["v"][:, slots] = v[:, n - sc:n]
        entry["pos"][:, slots] = tail.to(torch.int32)


class _RowDecode:
    """One contiguous-row decode step, shared by its layers: each row's
    query position ``cur`` (B,) int32, and per row length ``sc`` (full
    rows, rolling rows) the slots this step writes and, on the card, the
    rows' page view (``row_page_table``), each built once a step."""

    def __init__(self, cur: torch.Tensor, cache_len: int):
        self.cur = cur
        self.cache_len = cache_len
        self.rows = torch.arange(cur.shape[0], device=cur.device)
        self._slots: Dict[int, torch.Tensor] = {}
        self._tables: Dict[int, Any] = {}

    def slots(self, sc: int) -> torch.Tensor:
        if sc not in self._slots:
            self._slots[sc] = (self.cur % sc).long()
        return self._slots[sc]

    def table(self, sc: int):
        if self.cur.device.type == "cpu":
            return None
        if sc not in self._tables:
            self._tables[sc] = row_page_table(self.cur.shape[0], sc,
                                              self.cache_len,
                                              self.cur.device)
        return self._tables[sc]


# --------------------------------------------------------------------------
# layer application
# --------------------------------------------------------------------------

def _project(h: torch.Tensor, w: torch.Tensor,
             bias: Optional[torch.Tensor],
             impl: Optional[str] = None) -> torch.Tensor:
    d, nh, hd = w.shape
    y = dot(h, w.reshape(d, nh * hd), impl)
    y = y.reshape(h.shape[:-1] + (nh, hd))
    if bias is not None:
        y = y + bias
    return y


def _rope_q_k(cfg: ModelConfig, q: torch.Tensor, k: torch.Tensor,
              positions: torch.Tensor):
    """positions: (B, S), or (3, B, S) under M-RoPE."""
    if cfg.mrope_sections:
        return (apply_mrope(q, positions, cfg.mrope_sections, cfg.rope_theta),
                apply_mrope(k, positions, cfg.mrope_sections, cfg.rope_theta))
    return (apply_rope(q, positions, cfg.rope_theta),
            apply_rope(k, positions, cfg.rope_theta))


def _head_mask(cfg: ModelConfig, device,
               dtype) -> Optional[torch.Tensor]:
    """(He,) mask zeroing the padded q heads (``effective_num_heads``):
    the first ``num_heads / num_kv_heads`` heads of each KV group are
    real.  None without padding."""
    he, k = cfg.effective_num_heads, max(cfg.num_kv_heads, 1)
    if he == cfg.num_heads:
        return None
    gp, g = he // k, cfg.num_heads // k
    return (torch.arange(he, device=device) % gp < g).to(dtype)


def _attn_apply(p: Params, x: torch.Tensor, kind: str, cfg: ModelConfig,
                positions: torch.Tensor, *, entry=None, n_valid: int = 0,
                pages=None, layer: int = 0, paged=None,
                rows: Optional[_RowDecode] = None,
                impl: Optional[str] = None,
                par=None) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """One attention layer and its feed-forward block: (x, aux) with
    ``aux`` the MoE load-balancing loss (None for a dense block).
    ``par`` (train mode on a mesh): the rank's heads and ``d_ff``
    columns, entered and left through the mesh's Megatron hooks.
    ``impl="einsum"``: the plain attention (the roofline's probes, as
    the reference's take its einsum attention for exact FLOPs)."""
    a = p["attn"]
    B, S, _ = x.shape
    scale = cfg.query_scale or None
    window = cfg.window if kind == LOCAL else 0

    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    if par is not None:
        h = par.enter_tp(h)
    q = _project(h, a["wq"], a.get("bq"), impl)
    k = _project(h, a["wk"], a.get("bk"), impl)
    v = _project(h, a["wv"], a.get("bv"), impl)
    if kind != BIDIR or cfg.rope_theta > 0:
        q, k = _rope_q_k(cfg, q, k, positions)

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
    elif rows is not None:                     # decode, contiguous rows
        # each row r writes its k/v at slot cur[r] % sc and records the
        # position there (a rolling row overwrites its oldest slot)
        sc = entry["k"].shape[1]
        slot = rows.slots(sc)
        entry["k"][rows.rows, slot] = k[:, 0]
        entry["v"][rows.rows, slot] = v[:, 0]
        entry["pos"][rows.rows, slot] = rows.cur
        o = row_decode_attention(q, entry["k"], entry["v"], entry["pos"],
                                 rows.cur, cache_len=rows.cache_len,
                                 window=window, softcap=cfg.attn_softcap,
                                 scale=scale, table=rows.table(sc))
    else:
        attend = flash_attention_ref if impl == "einsum" else flash_attention
        o = attend(q, k, v, causal=(kind != BIDIR), window=window,
                   softcap=cfg.attn_softcap, scale=scale)
        if entry is not None:                            # prefill fills cache
            _fill_cache(entry, k, v, n_valid)

    hmask = _head_mask(cfg, o.device, o.dtype)
    if hmask is not None:
        if par is not None:                      # the rank's q heads
            hmask = hmask.narrow(0, par.head_offset(o.shape[2]), o.shape[2])
        o = o * hmask[:, None]
    H, hd, d = a["wo"].shape
    o = dot(o.reshape(B, S, H * hd), a["wo"].reshape(H * hd, d), impl)
    if par is not None:
        o = par.exit_tp(o)
    if cfg.sandwich_norm:
        o = rms_norm(o, p["ln1_post"], cfg.norm_eps)
    x = x + o
    h2 = rms_norm(x, p["ln2"], cfg.norm_eps)
    aux = None
    if cfg.num_experts:
        if impl == "abft":
            raise ValueError(f"impl={impl!r}: the MoE experts' products "
                             "have no checksummed route")
        m, aux = moe_apply(p["moe"], h2, num_experts=cfg.num_experts,
                           k=cfg.experts_per_token,
                           capacity_factor=cfg.capacity_factor,
                           act=_act(cfg.mlp_act), compute_dtype=cfg.dtype,
                           dead_experts=cfg.dead_experts, par=par)
    else:
        if par is not None:
            h2 = par.enter_tp(h2)
        m = mlp_apply(p["mlp"], h2, cfg.mlp_act, impl)
        if par is not None:
            m = par.exit_tp(m)
    if cfg.sandwich_norm:
        m = rms_norm(m, p["ln2_post"], cfg.norm_eps)
    return x + m, aux


# --------------------------------------------------------------------------
# full model
# --------------------------------------------------------------------------

def _embed_in(cfg: ModelConfig, params: Params,
              batch: Dict[str, Any]) -> torch.Tensor:
    """The input activations: token embeddings, or the batch's
    ``embeddings`` (B, S, D) for an embedding-input stack, in the compute
    dtype; times sqrt(d_model) with ``embed_scale``."""
    if cfg.embedding_inputs:
        # a view (one position of a longer batch) is copied: the kernels
        # read contiguous rows
        x = batch["embeddings"].to(cfg.dtype).contiguous()
    else:
        x = F.embedding(batch["tokens"].long(), params["embed"]["tok"])
    if cfg.embed_scale:
        x = x * torch.full((), cfg.d_model ** 0.5, dtype=x.dtype,
                           device=x.device)
    return x


def _positions_for(cfg: ModelConfig, batch: Dict[str, Any], B: int, S: int,
                   device, offset=0) -> torch.Tensor:
    """(B, S) positions from ``offset`` (an int or (B, 1)); under M-RoPE
    the batch's (3, B, S) ``positions`` when it carries them, else the
    same positions on all three axes (text), as in the reference."""
    if cfg.mrope_sections and "positions" in batch:
        return batch["positions"]
    pos = make_positions(B, S, device=device) + offset
    if cfg.mrope_sections:
        return pos[None].expand(3, B, S)
    return pos


def _logits_out(cfg: ModelConfig, params: Params,
                x: torch.Tensor) -> torch.Tensor:
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    if cfg.tie_embeddings and not cfg.embedding_inputs:
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
    leaf unbound into per-layer views (one stack in the backward), or the
    unstacked layers in order."""
    cd = cfg.dtype

    def cast(w, name=""):
        if (w.dtype == torch.float32 and cd != torch.float32
                and name.rsplit(".", 1)[-1] not in _KEEP_FP32):
            return w.to(cd)
        return w

    def cast_tree(t):
        return unflatten(t, [cast(w, n) for n, w in flatten_named(t)])

    if "blocks" in params:
        P_ = len(cfg.pattern)
        G = cfg.num_layers // P_
        layers: List[Params] = [None] * cfg.num_layers
        for p in range(P_):
            blk = params["blocks"][f"l{p}"]
            parts = [cast(w, name).unbind(0)
                     for name, w in flatten_named(blk)]
            for g in range(G):
                layers[g * P_ + p] = unflatten(blk, [pt[g] for pt in parts])
    else:
        layers = [cast_tree(params["layers"][f"layer_{i}"])
                  for i in range(cfg.num_layers)]
    top: Params = {"final_norm": cast(params["final_norm"])}
    for k in ("embed", "lm_head"):
        if k in params:
            top[k] = cast_tree(params[k])
    return top, layers


def _train_block(x, layers, kinds, cfg, positions, impl, par=None):
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for p, kind in zip(layers, kinds):
        if kind == SSM:
            x = ssm_apply(p, x, cfg, par=par)
            continue
        if kind == REC:
            x = rec_apply(p, x, cfg, par=par)
            continue
        x, a = _attn_apply(p, x, kind, cfg, positions, impl=impl, par=par)
        if a is not None:
            aux = aux + a
    return x, aux


def _forward_train(cfg: ModelConfig, params: Params,
                   batch: Dict[str, Any], impl: Optional[str] = None,
                   par=None, weights=None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(logits, aux).  ``weights``: (top, layers) already cast and
    unbound (a mesh step gathers its shards into them)."""
    top, layers = (weights if weights is not None
                   else _train_weights(cfg, params))
    x = _embed_in(cfg, top, batch)
    B, S = x.shape[:2]
    positions = _positions_for(cfg, batch, B, S, x.device)
    kinds = cfg.layer_kinds()
    # the reference's recomputed units: its scan body where the pattern
    # is 1 or 2 layers long, else each layer (recurrentgemma's 13-layer
    # block; the unstacked layout): only each unit's input is kept for
    # the backward
    unit = len(cfg.pattern) if (train_stacked(cfg)
                                and len(cfg.pattern) <= 2) else 1
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for g in range(0, cfg.num_layers, unit):
        x, a = checkpoint(_train_block, x, layers[g:g + unit],
                          kinds[g:g + unit], cfg, positions, impl, par,
                          use_reentrant=False)
        aux = aux + a
    return _logits_out(cfg, top, x), aux


def forward(cfg: ModelConfig, params: Params, batch: Dict[str, Any], *,
            mode: str = "prefill", cache=None, impl: Optional[str] = None):
    """Returns (logits, cache); the cache is updated in place.

    batch: ``tokens`` (B, S), or ``embeddings`` (B, S, D) for an
    embedding-input stack; under M-RoPE optionally ``positions`` (3, B, S)
    (text positions on all three axes without it).  ``train`` takes the
    train state's parameters (``init_train_params``) and returns (logits,
    aux), the MoE load-balancing loss summed over layers (zero for a
    dense stack).
    ``prefill`` may carry ``length``: only the first ``length`` positions
    are real (the rest is padding past them, which causal attention keeps
    out of every real position) and only those enter the cache; an SSM
    or RG-LRU stack refuses padding, which would run through its state.
    ``decode`` takes (B, 1) tokens and B cache rows; row r's token sits
    at position ``cache["index"][r]``, which prefill sets to the prompt's
    real length and each decode advances by one (the cache slot; under
    M-RoPE the rotary position is the batch's ``positions``, which may
    differ).  ``paged_decode``
    carries ``lengths`` (R,) int32, each row's query position, and
    ``page_tables`` (R, MPR) int32.  ``impl="abft"`` (train mode)
    checksums the projections."""
    kinds = cfg.layer_kinds()
    _check_kinds(cfg)
    if mode == "train":
        return _forward_train(cfg, params, batch, impl)
    if impl is not None:
        raise ValueError(f"impl={impl!r} applies to train mode only")
    x = _embed_in(cfg, params, batch)
    B, S = x.shape[:2]
    dev = x.device
    n_valid = int(batch.get("length", S))
    recurrent = sorted({k for k in kinds if k in (SSM, REC)})
    paged = None
    rows = None
    positions = None
    if mode == "paged_decode":
        if recurrent:
            raise ValueError(f"{cfg.name} has {recurrent} layers: their "
                             "state has no sequence axis to page")
        if cfg.mrope_sections:
            raise ValueError("paged decode does not support M-RoPE")
        if S != 1 or cache is None:
            raise ValueError("paged_decode takes (R, 1) tokens and the pool")
        lengths = batch["lengths"]
        page_tables = batch["page_tables"]
        positions = lengths.long()[:, None]                   # (R, 1)
        ps = cache["k"].shape[2]
        rows = torch.arange(B, device=dev)
        pidx = page_tables.long()[rows, positions[:, 0] // ps]
        paged = (page_tables, lengths, (pidx, positions[:, 0] % ps))
    elif mode == "decode":
        if S != 1 or cache is None:
            raise ValueError("decode takes (B, 1) tokens and B cache rows")
        rows = _RowDecode(cache["index"], cache["cache_len"])
        positions = _positions_for(cfg, batch, B, 1, dev,
                                   rows.cur.long()[:, None])
    elif mode == "prefill":
        if n_valid != S and recurrent:
            raise ValueError(f"{cfg.name}: a stack with {recurrent} layers "
                             "prefills at the prompt's own length (padding "
                             "would run through the recurrent and conv "
                             "state)")
        positions = _positions_for(cfg, batch, B, S, dev)
    else:
        raise ValueError(f"mode {mode!r}: the port runs train, prefill, "
                         "decode and paged_decode")
    for i, kind in enumerate(kinds):
        entry = (cache["layers"][i]
                 if mode in ("prefill", "decode") and cache is not None
                 else None)
        if kind == SSM:
            x = ssm_apply(params["layers"][i], x, cfg, entry)
            continue
        if kind == REC:
            x = rec_apply(params["layers"][i], x, cfg, entry)
            continue
        x, _ = _attn_apply(params["layers"][i], x, kind, cfg, positions,
                           entry=entry, n_valid=n_valid,
                           pages=cache if paged is not None else None,
                           layer=i, paged=paged, rows=rows)
    if mode == "prefill" and cache is not None:
        cache["index"].fill_(n_valid)
    elif mode == "decode":
        cache["index"] += 1
    return _logits_out(cfg, params, x), cache
