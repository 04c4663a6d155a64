"""Weights and train states carried across from the JAX package.

``params_from_jax`` takes the reference's ``init_params`` pytree as numpy
arrays (``jax.device_get``) and returns the port's serving parameters.
``state_from_jax`` takes the reference's whole train state (``params``,
``opt.{m,v,count}``, ``rng``, ``step``) and returns the port's, which
keeps the reference's stacked layout leaf for leaf.  The
reference stacks homogeneous blocks for ``scan``: ``{"embed": {"tok"},
"blocks": {"l<p>": {...}}, "final_norm"}`` with a leading G axis on every
block leaf, layer ``g * len(pattern) + p``.  The unstacked layout
(``"layers": {"layer_<i>": ...}``) is read too.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.base import ModelConfig
from repro_torch.models.transformer import load_weight
from repro_torch.tree import tree_map


def _tree(cfg, x, index, device):
    if isinstance(x, dict):
        return {k: _tree(cfg, v, index, device) for k, v in x.items()}
    a = np.asarray(x)
    if index is not None:
        a = a[index]
    t = torch.from_numpy(np.array(a, dtype=np.float32))
    return load_weight(cfg, t.to(device=device, dtype=cfg.param_dtype))


def params_from_jax(cfg: ModelConfig, tree: Dict[str, Any],
                    device=None) -> Dict[str, Any]:
    device = resolve_device(device)
    out: Dict[str, Any] = {
        "embed": _tree(cfg, tree["embed"], None, device),
        "final_norm": _tree(cfg, tree["final_norm"], None, device)}
    if "lm_head" in tree:
        out["lm_head"] = _tree(cfg, tree["lm_head"], None, device)
    if "blocks" in tree:
        P_ = len(cfg.pattern)
        out["layers"] = [
            _tree(cfg, tree["blocks"][f"l{i % P_}"], i // P_, device)
            for i in range(cfg.num_layers)]
    else:
        out["layers"] = [_tree(cfg, tree["layers"][f"layer_{i}"], None,
                               device) for i in range(cfg.num_layers)]
    return out


def state_from_jax(cfg: ModelConfig, tree: Dict[str, Any],
                   device=None) -> Dict[str, Any]:
    """The reference's train state (numpy leaves) as the port's: the same
    tree, every leaf a tensor of the same dtype and bits on ``device``."""
    device = resolve_device(device)
    if "blocks" not in tree["params"]:
        raise ValueError(f"{cfg.name}: the port's train state stacks its "
                         "blocks (the reference's scan_layers=True)")
    return tree_map(lambda a: torch.from_numpy(np.array(a)).to(device),
                    tree)
