"""AdamW (fp32 moments, decoupled weight decay), the reference's
``optim/adamw.py`` over the port's trees.  Functional: returns new
tensors and leaves its inputs untouched, so a caller may keep an earlier
state (``run_with_recovery`` keeps the initial one)."""
from __future__ import annotations

import torch

from repro_torch.tree import leaves, tree_map, unflatten


def adamw_init(params):
    return {
        "m": tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                            device=p.device), params),
        "v": tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                            device=p.device), params),
        "count": torch.zeros((), dtype=torch.int32,
                             device=leaves(params)[0].device),
    }


def adamw_update(grads, opt, params, *, lr, b1=0.9, b2=0.95, eps=1e-8,
                 weight_decay=0.1):
    """Returns (new_params, new_opt).  ``lr`` may be a 0-dim tensor."""
    count = opt["count"] + 1
    cf = count.to(torch.float32)
    bc1 = 1.0 - torch.pow(torch.full_like(cf, b1), cf)
    bc2 = 1.0 - torch.pow(torch.full_like(cf, b2), cf)

    def upd(g, m, v, p):
        gf = g.to(torch.float32)
        m2 = b1 * m + (1.0 - b1) * gf
        v2 = b2 * v + (1.0 - b2) * gf * gf
        mh = m2 / bc1
        vh = v2 / bc2
        step = mh / (torch.sqrt(vh) + eps)
        if weight_decay:
            step = step + weight_decay * p.to(torch.float32)
        p2 = p.to(torch.float32) - lr * step
        return p2.to(p.dtype), m2, v2

    out = [upd(g, m, v, p) for g, m, v, p in
           zip(leaves(grads), leaves(opt["m"]), leaves(opt["v"]),
               leaves(params))]
    return (unflatten(params, [o[0] for o in out]),
            {"m": unflatten(params, [o[1] for o in out]),
             "v": unflatten(params, [o[2] for o in out]),
             "count": count})
