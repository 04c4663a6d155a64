"""The assigned input-shape cells and each cell's arguments, global
shapes and shards on the meta device (the reference's
``launch/shapes.py``).

LM-family shapes (per assignment):
  train_4k      seq 4096,    global_batch 256   (train_step)
  prefill_32k   seq 32768,   global_batch 32    (prefill)
  decode_32k    seq 32768,   global_batch 128   (decode: 1 token, full cache)
  long_500k     seq 524288,  global_batch 1     (decode; sub-quadratic only)

Each ``*_sds`` returns ``(tree, shardings)``: meta tensors of the global
shapes and dtypes (the port's ``ShapeDtypeStruct``s: nothing is
allocated) and the matching tree of ``NamedSharding`` on the mesh (None
without one).  ``shard_shapes`` and ``shard_bytes`` give any rank's
shards (``NamedSharding.spans``).  The reference's rules: the batch dim
over ``DP_AXES`` only when the batch divides DP; serving weights in the
compute dtype, their FSDP split dropped when a TP shard of the model is
under ``SERVE_FSDP_THRESHOLD_BYTES``; a cache batch dim replicated where
it does not divide DP.

Two departures from the reference's trees, both the port's own layouts:

- the decode cache (``cache_sds``) is the port's ``init_cache``: one
  entry a layer, ``pos`` (B, sc) and ``index`` (B,) a row (PR 23), where
  the reference stacks layers and keeps ``pos`` (sc,) and a scalar
  ``index``; ``pos`` is split as its layer's k rows are (batch over DP,
  positions over ``"model"``), ``index`` over DP;
- serving weights keep ``A_log``, ``D`` and ``lam`` in float32
  (``transformer._KEEP_FP32``, as the port's serving holds them) where
  the reference casts every float32 leaf to the compute dtype.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.models.base import BIDIR, FULL, LOCAL, REC, SSM, ModelConfig
from repro_torch.models.transformer import (_KEEP_FP32, init_cache,
                                            init_train_params)
from repro_torch.sharding.api import Mesh, NamedSharding
from repro_torch.sharding.api import PartitionSpec as P
from repro_torch.sharding.api import resolve
from repro_torch.sharding.rules import DP_AXES, TP, param_specs, state_specs
from repro_torch.train.state import init_state
from repro_torch.tree import flatten_named, leaves, tree_map, unflatten

META = torch.device("meta")

SHAPES: Dict[str, Tuple[int, int, str]] = {
    "train_4k": (4096, 256, "train"),
    "prefill_32k": (32768, 32, "prefill"),
    "decode_32k": (32768, 128, "decode"),
    "long_500k": (524288, 1, "decode"),
}

# Serving keeps weights FSDP-sharded only when a TP shard of the bf16 model
# would exceed this per-device budget; below it, weights replicate across DP
# (zero per-layer gathers at inference).
SERVE_FSDP_THRESHOLD_BYTES = 4 << 30


def cell_applicable(cfg: ModelConfig, shape_name: str
                    ) -> Tuple[bool, Optional[str]]:
    seq, batch, mode = SHAPES[shape_name]
    if mode == "decode" and not cfg.has_decode:
        return False, "encoder-only arch has no decode step"
    if shape_name == "long_500k" and not cfg.subquadratic:
        return False, ("full-attention arch: 500k KV cache is infeasible "
                       "(quadratic); see DESIGN.md S5")
    return True, None


def _dp_size(mesh: Mesh) -> int:
    sizes = mesh.shape
    return sizes.get("data", 1) * sizes.get("pod", 1)


def _tp_size(mesh: Mesh) -> int:
    return mesh.shape.get("model", 1)


def _resolve_tree(specs, mesh: Optional[Mesh]):
    if mesh is None:
        return None
    return tree_map(lambda sp: resolve(sp, mesh), specs)


def batch_sds(cfg: ModelConfig, seq: int, batch: int, mesh: Optional[Mesh],
              mode: str):
    """The input batch of one step."""
    dp = _dp_size(mesh) if mesh else 1
    bspec = DP_AXES if (batch % dp == 0 and dp > 1) else None
    s = 1 if mode == "decode" else seq
    out: Dict = {}
    specs: Dict = {}
    if cfg.embedding_inputs:
        out["embeddings"] = torch.empty(batch, s, cfg.d_model,
                                        dtype=cfg.dtype, device=META)
        specs["embeddings"] = P(bspec, None, None)
    else:
        out["tokens"] = torch.empty(batch, s, dtype=torch.int32,
                                    device=META)
        specs["tokens"] = P(bspec, None)
    if mode == "train":
        out["targets"] = torch.empty(batch, s, dtype=torch.int32,
                                     device=META)
        specs["targets"] = P(bspec, None)
    if cfg.mrope_sections:
        out["positions"] = torch.empty(3, batch, s, dtype=torch.int32,
                                       device=META)
        specs["positions"] = P(None, bspec, None)
    return out, _resolve_tree(specs, mesh)


def state_sds(cfg: ModelConfig, mesh: Optional[Mesh], moe_ep=False):
    """The TrainState (``init_state`` on the meta device)."""
    st = init_state(cfg, seed=0, device=META)
    if mesh is None:
        return st, None
    return st, _resolve_tree(state_specs(cfg, _tp_size(mesh), moe_ep), mesh)


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


def params_sds(cfg: ModelConfig, mesh: Optional[Mesh], moe_ep=False,
               serve_dtype: bool = True):
    """Parameters in the train state's layout.  For serving (prefill /
    decode) float32 weights are cast to the compute dtype (master copies
    are a training-only concern), ``_KEEP_FP32`` leaves excepted."""
    params = init_train_params(cfg, seed=0, device=META)
    if serve_dtype:
        params = unflatten(params, [
            x.to(cfg.dtype) if (x.dtype == torch.float32
                                and name.rsplit(".", 1)[-1] not in _KEEP_FP32)
            else x for name, x in flatten_named(params)])
    if mesh is None:
        return params, None
    specs = param_specs(cfg, _tp_size(mesh), moe_ep)
    if serve_dtype:
        total = sum(_nbytes(x) for x in leaves(params))
        if total / max(_tp_size(mesh), 1) < SERVE_FSDP_THRESHOLD_BYTES:
            specs = tree_map(
                lambda p: P(*(None if e == "data" else e for e in p)), specs)
    return params, _resolve_tree(specs, mesh)


def _cache_layer_spec(kind: str) -> Dict[str, P]:
    if kind in (FULL, LOCAL, BIDIR):
        return {"k": P(DP_AXES, TP, None, None),
                "v": P(DP_AXES, TP, None, None),
                "pos": P(DP_AXES, TP)}
    if kind == SSM:
        return {"conv": P(DP_AXES, None, TP), "h": P(DP_AXES, TP, None)}
    if kind == REC:
        return {"conv": P(DP_AXES, None, TP), "h": P(DP_AXES, TP)}
    raise ValueError(kind)


def cache_sds(cfg: ModelConfig, batch: int, cache_len: int,
              mesh: Optional[Mesh]):
    """The port's decode cache rows (module docstring); ``cache_len``
    stays the int it is."""
    cache = init_cache(cfg, batch, cache_len, META)
    if mesh is None:
        return cache, None
    dp = _dp_size(mesh)

    def fix_batch(spec: P, shape) -> P:
        # replicate the batch dim when it doesn't divide DP
        return P(*(None if (e == DP_AXES and shape[i] % dp) else e
                   for i, e in enumerate(spec)))

    layers = []
    for kind, entry in zip(cfg.layer_kinds(), cache["layers"]):
        specs = _cache_layer_spec(kind)
        layers.append({k: resolve(fix_batch(specs[k], x.shape), mesh)
                       for k, x in entry.items()})
    index = resolve(fix_batch(P(DP_AXES), cache["index"].shape), mesh)
    return cache, {"layers": layers, "index": index, "cache_len": None}


def input_specs(cfg: ModelConfig, shape_name: str, mesh: Optional[Mesh],
                moe_ep=False):
    """``(mode, args, shardings)`` for the cell's step: ``args`` is
    ``(state, batch)`` for a train cell and ``(params, batch, cache)``
    for a serve cell, ``shardings`` the matching ``NamedSharding`` trees
    (None without a mesh)."""
    seq, batch, mode = SHAPES[shape_name]
    ok, reason = cell_applicable(cfg, shape_name)
    if not ok:
        raise ValueError(f"cell not applicable: {reason}")
    b, b_sh = batch_sds(cfg, seq, batch, mesh, mode)
    if mode == "train":
        st, st_sh = state_sds(cfg, mesh, moe_ep)
        return mode, (st, b), (st_sh, b_sh)
    pr, pr_sh = params_sds(cfg, mesh, moe_ep)
    ca, ca_sh = cache_sds(cfg, batch, seq, mesh)
    return mode, (pr, b, ca), (pr_sh, b_sh, ca_sh)


def shard_shapes(tree, shardings, rank: int):
    """Rank ``rank``'s shard shape of every tensor leaf of ``tree``, in
    ``flatten_named`` order (``NamedSharding.spans``; whole without a
    sharding)."""
    by_name = dict(flatten_named(shardings))
    out = {}
    for name, x in flatten_named(tree):
        if not isinstance(x, torch.Tensor):
            continue
        sh = by_name.get(name)
        if not isinstance(sh, NamedSharding):
            out[name] = tuple(x.shape)
            continue
        out[name] = tuple(b - a for a, b in sh.spans(x.shape, rank))
    return out


def shard_bytes(tree, shardings, rank: int) -> int:
    """The bytes of rank ``rank``'s shards of ``tree``."""
    dtypes = {n: x.element_size() for n, x in flatten_named(tree)
              if isinstance(x, torch.Tensor)}
    total = 0
    for name, shape in shard_shapes(tree, shardings, rank).items():
        n = 1
        for d in shape:
            n *= d
        total += n * dtypes[name]
    return total
