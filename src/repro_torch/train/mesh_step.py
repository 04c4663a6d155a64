"""The train step on a rank mesh: each rank computes only its shards.

Layout (the reference's spec tables, ``sharding/rules.py``):

- ``"data"``: the rank's contiguous slice of the global batch rows; every
  parameter is stored split over ``"data"`` along its FSDP dim (or whole,
  as the norms and the router are) and gathered for use, once a step
  (``comm.gather_sum``: the backward sums the gradient over ``"data"``
  in rank order and keeps the rank's slice, once a step: the
  microbatches' gradients of the gathered weights add up first);
- ``"model"``: the rank's heads and ``d_ff`` columns, Megatron column
  and row parallel (``par.enter_tp`` before the projections, the row
  products summed by ``par.exit_tp``); the vocab-split embedding and
  head are gathered over ``"model"`` and the logits computed whole;
- ``"expert"``: the rank's experts (``layers/moe.py`` with ``par``); the
  combine sums over ``("model", "expert")``.

Every rank of a ``("model", "expert")`` group holds the same batch rows
and, after each sum, the same activations bit for bit, so the replicated
parameters' gradients agree without a sum there.  The loss is the batch
mean: each rank's row mean weighted by its share of the rows.  The
global gradient norm sums squares over the shards each leaf's replica 0
holds, over the whole mesh in rank order.  AdamW updates each rank's
shards.  All collectives go through ``sharding/comm.py``.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List

import numpy as np
import torch

from repro_torch.data.pipeline import even_spans
from repro_torch.device import deterministic_algorithms
from repro_torch.models.base import FULL, LOCAL, ModelConfig
from repro_torch.models.transformer import (_KEEP_FP32, _forward_train,
                                            _train_weights)
from repro_torch.optim import adamw_update, adamw_update_, cosine_schedule
from repro_torch.sharding import comm
from repro_torch.sharding.api import Mesh, chunk_span
from repro_torch.train.state import next_rng
from repro_torch.train.step import AUX_WEIGHT, causal_nll
from repro_torch.tree import flatten_named, leaves, tree_map, unflatten

# leaves whose "model" split is gathered for a whole-vocab computation
_VOCAB_LEAVES = ("embed.tok", "lm_head")


class MeshPar:
    """The mesh hooks the model code calls (``par``)."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh
        shape, c = mesh.shape, mesh.coord()
        self.data_group = mesh.group(("data",))
        self.data_weight = 1.0        # this rank's share of the batch rows
        self.tp_group = mesh.group(("model",))
        self.shard_group = mesh.group(("model", "expert"))
        self.ep = shape.get("expert", 1)
        self.ep_index = c.get("expert", 0)

    def enter_tp(self, x):
        return comm.enter(x, self.tp_group)

    def exit_tp(self, x):
        return comm.leave(x, self.tp_group)

    def enter_shard(self, x):
        return comm.enter(x, self.shard_group)

    def exit_shard(self, x):
        return comm.leave(x, self.shard_group)

    def batch_mean(self, x):
        return comm.weighted_sum(x, self.data_group, self.data_weight)

    def expert_range(self, num_experts: int):
        per = num_experts // self.ep
        return self.ep_index * per, per


def check_mesh_model(cfg: ModelConfig) -> None:
    """The models the mesh step trains: causal attention stacks over
    token inputs, without padded q heads."""
    bad = sorted({k for k in cfg.layer_kinds() if k not in (FULL, LOCAL)})
    if bad:
        raise NotImplementedError(
            f"{cfg.name}: the mesh step runs causal attention stacks "
            f"(dense or MoE); {bad} layers train on one rank")
    why = [w for w, on in (
        ("embedding inputs", cfg.embedding_inputs),
        ("padded q heads", cfg.effective_num_heads != cfg.num_heads)) if on]
    if why:
        raise NotImplementedError(
            f"{cfg.name} has {' and '.join(why)}: it trains on one rank "
            "(a mesh step for them is a lead of ROADMAP's mesh work left "
            "from item 10)")


def check_mesh_config(cfg: ModelConfig, mesh: Mesh) -> None:
    """The models and layouts the mesh step computes."""
    check_mesh_model(cfg)
    shape = mesh.shape
    tp, ep = shape.get("model", 1), shape.get("expert", 1)
    if cfg.num_kv_heads % tp or cfg.num_heads % tp or cfg.d_ff % tp:
        raise ValueError(f"{cfg.name}: tp={tp} must divide the q and kv "
                         "heads and d_ff")
    if ep > 1 and (not cfg.num_experts or cfg.num_experts % ep):
        raise ValueError(f"{cfg.name}: ep={ep} must divide the experts")


def leaf_sizes(n: int, parts: int) -> List[int]:
    return [b - a for a, b in (chunk_span(n, parts, i) for i in range(parts))]


def shard_tree(tree, shardings):
    """Each leaf's shard for the calling rank (the reference's
    ``device_put`` onto shardings), a copy on the mesh's device."""
    def one(x, sh):
        if sh is None or not isinstance(x, torch.Tensor):
            return x
        y = sh.local(x)
        return y.to(sh.mesh.device or y.device).clone()
    return tree_map(one, tree, shardings)


def gather_weights(cfg: ModelConfig, params, shardings, shapes: Dict,
                   mesh: Mesh):
    """The rank's local parameter shards gathered over ``"data"`` (and
    the vocab leaves over ``"model"``), cast to the compute dtype inside
    the autograd graph, in the stacked train layout (never a shard
    itself: a view where nothing is gathered)."""
    data_group = mesh.group(("data",))
    tp_group = mesh.group(("model",))
    sizes = mesh.shape
    cd = cfg.dtype
    out = []
    for (name, x), sh in zip(flatten_named(params), leaves(shardings)):
        if (x.dtype == torch.float32 and cd != torch.float32
                and name.rsplit(".", 1)[-1] not in _KEEP_FP32):
            x = x.to(cd)
        axes = sh.dim_axes(x.ndim)
        gshape = shapes["params." + name]
        ddim = next((i for i, a in enumerate(axes) if "data" in a), None)
        dsz = (leaf_sizes(gshape[ddim], sizes.get("data", 1))
               if ddim is not None else ())
        x = comm.gather_sum(x, data_group, ddim, dsz)
        if name in _VOCAB_LEAVES:
            mdim = next((i for i, a in enumerate(axes) if "model" in a),
                        None)
            if mdim is not None:
                x = comm.gather_slice(
                    x, tp_group, mdim,
                    leaf_sizes(gshape[mdim], sizes["model"]))
        out.append(x.view_as(x))
    return unflatten(params, out)


def make_mesh_train_step(cfg: ModelConfig, mesh: Mesh, shardings,
                         like, *, peak_lr: float = 3e-4,
                         warmup_steps: int = 100, total_steps: int = 10_000,
                         weight_decay: float = 0.1, clip_norm: float = 1.0,
                         microbatches: int = 1,
                         donate: bool = False) -> Callable:
    """``train_step(state, batch) -> (state, metrics)`` over the calling
    rank's shards of the train state.  ``shardings``: the state's
    ``NamedSharding`` tree on ``mesh`` (``sharding.rules.state_specs``
    resolved); ``like``: a tree of the state's global shapes (e.g.
    ``init_state(cfg, device="meta")``).  ``batch``: the global batch
    (every rank sees the same); the rank takes its ``"data"`` rows.

    ``donate``: the step consumes the given state, as JAX's donated
    arguments: AdamW updates its leaves in place (``adamw_update_``), so
    a rank holds a few temporaries of one leaf at the update, not a
    second state (ranks sharing one card each keep their own allocator's
    peak).  Without it the same update runs on copies and the given state
    stays intact."""
    check_mesh_config(cfg, mesh)
    lr_fn = cosine_schedule(peak_lr, warmup_steps, total_steps)
    par = MeshPar(mesh)
    shapes = {n: tuple(x.shape) for n, x in flatten_named(like)}
    p_shard = shardings["params"]
    flat_sh = leaves(p_shard)
    coord = mesh.coord()
    dp = mesh.shape.get("data", 1)
    data_group = mesh.group(("data",))
    world_group = mesh.group(mesh.axis_names)
    replica0 = [sh.replica_id() == 0 for sh in flat_sh]

    def local_loss(gathered, tokens, targets, weight):
        weights = _train_weights(cfg, gathered)
        logits, aux = _forward_train(cfg, None, {"tokens": tokens},
                                     par=par, weights=weights)
        nll = causal_nll(cfg, logits, targets)
        loss = nll + AUX_WEIGHT * aux
        return loss * weight, nll * weight, aux * weight

    def train_step(state, batch):
        dev = state["step"].device
        rng = next_rng(state["rng"])
        batch = {k: (x if isinstance(x, torch.Tensor)
                     else torch.from_numpy(np.array(x))).to(dev)
                 for k, x in batch.items()}
        B = batch["tokens"].shape[0]
        a, b = even_spans(B, dp)[coord.get("data", 0)]
        rows = {k: x[a:b] for k, x in batch.items()}
        n = b - a
        if n % microbatches:
            raise ValueError(f"{n} local rows not divisible by "
                             f"{microbatches} microbatches")
        mb = n // microbatches
        par.data_weight = n / B
        params = state["params"]
        with deterministic_algorithms(dev):
            live = [p.detach().requires_grad_(True) for p in leaves(params)]
            # one gather a step, shared by the microbatches ...
            gathered = leaves(gather_weights(cfg, unflatten(params, live),
                                             p_shard, shapes, mesh))
            use = [g.detach().requires_grad_(True) for g in gathered]
            use_tree = unflatten(params, use)
            acc = None
            sums = torch.zeros(3, dtype=torch.float32, device=dev)
            for i in range(microbatches):
                sl = slice(i * mb, (i + 1) * mb)
                loss, nll, aux = local_loss(use_tree, rows["tokens"][sl],
                                            rows["targets"][sl],
                                            n / B / microbatches)
                g_ = torch.autograd.grad(loss, use)
                sums += torch.stack([loss.detach(), nll.detach(),
                                     aux.detach()])
                if acc is None:
                    acc = list(g_)
                else:                   # in the gathered weights' dtype
                    for a_, g in zip(acc, g_):
                        a_.add_(g)
                del g_, loss, nll, aux
            del use, use_tree
            # ... and one reduction: back through the gathers (the FSDP
            # gradient sums over "data") to the rank's shards
            grads = list(torch.autograd.grad(gathered, live,
                                             grad_outputs=acc))
            del acc, gathered, live
            # the rows' weighted means summed over "data": the batch mean
            sums = comm.ordered_sum(sums, data_group)
            sq = torch.zeros((), dtype=torch.float32, device=dev)
            for g, r0 in zip(grads, replica0):
                if r0:
                    sq = sq + torch.sum(g.to(torch.float32) ** 2)
            gnorm = torch.sqrt(comm.ordered_sum(sq, world_group))
            scale = torch.clamp(torch.full_like(gnorm, clip_norm)
                                / torch.clamp_min(gnorm, 1e-12), max=1.0)
            lr = lr_fn(state["step"])
            if donate:
                adamw_update_(grads, state["opt"], params, lr=lr,
                              scale=scale, weight_decay=weight_decay)
                new_params, new_opt = params, state["opt"]
            else:
                new_params, new_opt = adamw_update(
                    grads, state["opt"], params, lr=lr, scale=scale,
                    weight_decay=weight_decay)
        new_state = {"step": state["step"] + 1, "params": new_params,
                     "opt": new_opt, "rng": rng}
        loss, nll, aux = sums[0], sums[1], sums[2]
        finite = torch.isfinite(loss) & torch.isfinite(gnorm)
        out: Dict[str, Any] = {
            "loss": loss, "grad_norm": gnorm, "lr": lr,
            "nonfinite": (~finite).to(torch.float32), "nll": nll,
            "aux": aux}
        return new_state, out

    return train_step


def state_shardings(cfg: ModelConfig, mesh: Mesh, moe_ep=False):
    """The train state's ``NamedSharding`` tree on ``mesh``."""
    from repro_torch.sharding.api import resolve
    from repro_torch.sharding.rules import state_specs

    tp = mesh.shape.get("model", 1)
    return tree_map(lambda s: resolve(s, mesh),
                    state_specs(cfg, tp, moe_ep))


def mesh_combos(mesh: Mesh):
    """The axis combinations the mesh step sums over (for
    ``Mesh.init_groups``)."""
    return [("model", "expert"), tuple(mesh.axis_names)]


def init_sharded_state(cfg: ModelConfig, shardings, *, seed: int = 0,
                       device=None, world=None, ranks=None):
    """The calling rank's shards of ``init_state(cfg, seed=seed)``: the
    whole parameter tree is drawn on ``device`` (the same numbers as on
    one rank), sliced and freed; the moments start as zeros of the
    shards.  With ``world`` the ranks (``ranks``, default every rank of
    the run) draw one after another, so only one whole tree exists at a
    time on a shared card."""
    from repro_torch.models.transformer import init_train_params
    from repro_torch.optim import adamw_init
    from repro_torch.prng import prng_key
    from repro_torch.train.state import key_tensor

    def draw():
        full = init_train_params(cfg, seed=seed, device=device)
        local = shard_tree(full, shardings["params"])
        del full
        return local

    if world is None:
        params = draw()
    else:
        params = None
        ranks = list(range(world.size)) if ranks is None else list(ranks)
        for r in ranks:
            if r == world.rank:
                params = draw()
                if torch.device(device).type == "cuda":
                    torch.cuda.empty_cache()
            world.barrier("init_sharded_state", ranks)
    dev = next(iter(leaves(params))).device
    return {"step": torch.zeros((), dtype=torch.int32, device=dev),
            "params": params, "opt": adamw_init(params),
            "rng": key_tensor(prng_key(0), dev)}
