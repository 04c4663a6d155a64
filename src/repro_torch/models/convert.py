"""Weights and train states carried across from the JAX package.

``params_from_jax`` takes the reference's ``init_params`` pytree as numpy
arrays (``jax.device_get``), or the port's own train parameters
(``init_train_params``, the same stacked layout, tensors), and returns
the port's serving parameters, cast as ``load_weight`` casts them (an
SSM layer's ``A_log`` and ``D`` and an RG-LRU layer's ``lam`` stay
float32): a model trained in either package serves in the port.  Every
leaf keeps its shape: padded q heads (``pad_heads_to``) stay padded, and
an embedding-input model has no ``embed``.  ``state_from_jax`` takes the
reference's whole train state (``params``, ``opt.{m,v,count}``, ``rng``,
``step``) and returns the port's, which keeps the reference's layout
leaf for leaf, stacked or not.  The
reference stacks homogeneous blocks for ``scan``: ``{"embed": {"tok"},
"blocks": {"l<p>": {...}}, "final_norm"}`` with a leading G axis on every
block leaf, layer ``g * len(pattern) + p`` (recurrentgemma-2b's 26
layers: 2 blocks of its 13-layer pattern).  The unstacked layout
(``"layers": {"layer_<i>": ...}``, the reference's ``scan_layers=False``,
e.g. tiny recurrentgemma's 5 layers over a pattern of 3) is read too.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.base import ModelConfig
from repro_torch.models.transformer import load_weight
from repro_torch.tree import tree_map


def _tree(cfg, x, index, device, name=""):
    if isinstance(x, dict):
        return {k: _tree(cfg, v, index, device, k) for k, v in x.items()}
    if isinstance(x, torch.Tensor):
        t = (x if index is None else x[index]).detach().float()
    else:
        a = np.asarray(x)
        if index is not None:
            a = a[index]
        t = torch.from_numpy(np.array(a, dtype=np.float32))
    return load_weight(cfg, t.to(device=device, dtype=cfg.param_dtype),
                       name)


def params_from_jax(cfg: ModelConfig, tree: Dict[str, Any],
                    device=None) -> Dict[str, Any]:
    device = resolve_device(device)
    out: Dict[str, Any] = {
        k: _tree(cfg, tree[k], None, device)
        for k in ("embed", "final_norm", "lm_head") if k in tree}
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
    return tree_map(lambda a: torch.from_numpy(np.array(a)).to(device),
                    tree)
