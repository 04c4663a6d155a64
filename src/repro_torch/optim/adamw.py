"""AdamW (fp32 moments, decoupled weight decay), the reference's
``optim/adamw.py`` over the port's trees.  ``adamw_update_`` updates a
donated state in place, leaf by leaf: it holds a few temporaries of one
leaf, not a second state.  ``adamw_update`` is the functional form, the
same update on copies: it leaves its inputs untouched, so a caller may
keep an earlier state (``run_with_recovery`` keeps the initial one)."""
from __future__ import annotations

import torch

from repro_torch.tree import leaves, tree_map


def adamw_init(params):
    return {
        "m": tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                            device=p.device), params),
        "v": tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                            device=p.device), params),
        "count": torch.zeros((), dtype=torch.int32,
                             device=leaves(params)[0].device),
    }


def adamw_update(grads, opt, params, *, lr, scale=None, b1=0.9, b2=0.95,
                 eps=1e-8, weight_decay=0.1):
    """Returns (new_params, new_opt): ``adamw_update_`` on copies of
    ``params`` and ``opt``.  ``lr`` may be a 0-dim tensor."""
    new_params = tree_map(torch.clone, params)
    new_opt = {"m": tree_map(torch.clone, opt["m"]),
               "v": tree_map(torch.clone, opt["v"]), "count": opt["count"]}
    adamw_update_(leaves(grads), new_opt, new_params, lr=lr, scale=scale,
                  b1=b1, b2=b2, eps=eps, weight_decay=weight_decay)
    return new_params, new_opt


def adamw_update_(grads, opt, params, *, lr, scale=None, b1=0.9, b2=0.95,
                  eps=1e-8, weight_decay=0.1) -> None:
    """AdamW in place: ``params`` and ``opt`` (its ``m``, ``v`` and
    ``count``) are updated; ``grads`` is a list in leaf order whose
    entries are dropped as they are used.  ``scale`` (a 0-dim tensor):
    each gradient is first multiplied by it in float32 and rounded back
    to its dtype, as clipping does."""
    count = opt["count"] + 1
    cf = count.to(torch.float32)
    bc1 = 1.0 - torch.pow(torch.full_like(cf, b1), cf)
    bc2 = 1.0 - torch.pow(torch.full_like(cf, b2), cf)
    for i, (p, m, v) in enumerate(zip(leaves(params), leaves(opt["m"]),
                                      leaves(opt["v"]))):
        g = grads[i]
        grads[i] = None
        if scale is not None:
            g = (g.to(torch.float32) * scale).to(g.dtype)
        gf = g.to(torch.float32)
        del g
        m.mul_(b1).add_((1.0 - b1) * gf)
        t = (1.0 - b2) * gf
        t.mul_(gf)
        del gf
        v.mul_(b2).add_(t)
        del t
        mh = m / bc1
        vh = v / bc2
        vh.sqrt_().add_(eps)
        mh.div_(vh)
        del vh
        if weight_decay:
            mh.add_(weight_decay * p.to(torch.float32))
        if p.dtype == torch.float32:
            p.sub_(lr * mh)
        else:
            p.copy_((p.to(torch.float32) - lr * mh).to(p.dtype))
        del mh
    opt["count"] = count
