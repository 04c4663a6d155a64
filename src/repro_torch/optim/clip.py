"""Global-norm gradient clipping (the reference's ``optim/clip.py``)."""
from __future__ import annotations

import torch

from repro_torch.tree import leaves, tree_map


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, leaves added in the
    reference's order."""
    total = None
    for leaf in leaves(tree):
        sq = torch.sum(leaf.to(torch.float32) ** 2)
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def clip_by_global_norm(tree, max_norm: float):
    n = global_norm(tree)
    scale = torch.clamp(torch.full_like(n, max_norm)
                        / torch.clamp_min(n, 1e-12), max=1.0)
    return tree_map(lambda g: (g.to(torch.float32) * scale).to(g.dtype),
                    tree), n
