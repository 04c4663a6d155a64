"""The train step on a rank mesh: each rank computes only its shards.

Layout (the reference's spec tables, ``sharding/rules.py``), for every
family the single-rank step trains:

- ``("pod", "data")`` (``DP_AXES``): the rank's contiguous slice of the
  global batch rows (``tokens`` or ``embeddings``, ``targets``, and
  ``positions`` along its axis 1); every parameter is stored split over
  ``"data"`` along its FSDP dim (or whole, as the norms and the router
  are) and gathered for use, once a step (``comm.gather_sum``: the
  backward sums the gradient over ``"data"`` in rank order and keeps the
  rank's slice, once a step: the microbatches' gradients of the gathered
  weights add up first), then summed over ``"pod"`` in rank order;
- ``"model"``: the rank's q heads, ``d_ff`` columns, SSM channels and
  RG-LRU channels, Megatron column and row parallel (``par.enter_tp``
  before the projections, the row products summed by ``par.exit_tp``);
  the vocab-split embedding and head are gathered over ``"model"`` and
  the logits computed whole;
- ``"expert"``: the rank's experts (``layers/moe.py`` with ``par``); the
  combine sums over ``("model", "expert")``.

Where the spec table does not split a leaf the way a rank uses it:

- kv heads that ``"model"`` does not divide are stored whole
  (``rules.py:_attn_specs``); each rank takes the kv heads its q heads
  map to (``kv_heads``), so these leaves' gradients differ from rank to
  rank and are summed over ``"model"`` in rank order (``comm.enter`` on
  the gathered leaf);
- a Mamba ``in_proj`` is one (D, 2 Di) leaf, x then z, its columns split
  over ``"model"``: its contiguous shard is not the rank's channels, so
  the leaf is gathered over ``"model"`` and the rank's x and z columns
  taken (the backward sums the gradient over ``"model"``, each rank
  adding its own columns);
- inside an SSM layer ``x_proj`` is row-parallel, and each rank uses
  its sum on its own channels only: the sum's backward is a sum too
  (``par.sum_tp``); an RG-LRU layer's gates read every channel: its
  convolved input is gathered over ``"model"`` (``par.gather_tp``).

Every rank of a ``("model", "expert")`` group holds the same batch rows
and, after each sum, the same activations bit for bit, so the other
replicated parameters' gradients agree without a sum there.  The loss
is the batch mean: each rank's row mean weighted by its share of the
rows.  The global gradient norm sums squares over the shards each
leaf's replica 0 holds, over the whole mesh in rank order.  AdamW
updates each rank's shards.  All collectives go through
``sharding/comm.py``.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.data.pipeline import even_spans
from repro_torch.device import deterministic_algorithms
from repro_torch.models.base import REC, SSM, ModelConfig
from repro_torch.models.transformer import (_KEEP_FP32, _forward_train,
                                            _train_weights)
from repro_torch.optim import adamw_update, adamw_update_, cosine_schedule
from repro_torch.sharding import comm
from repro_torch.sharding.api import Mesh, chunk_span
from repro_torch.sharding.rules import DP_AXES
from repro_torch.train.state import next_rng
from repro_torch.train.step import AUX_WEIGHT, causal_nll
from repro_torch.tree import flatten_named, leaves, tree_map, unflatten

# leaves whose "model" split is gathered for a whole-vocab computation
_VOCAB_LEAVES = ("embed.tok", "lm_head")
# attention leaves with a kv-head dim (second to last)
_KV_LEAVES = ("attn.wk", "attn.wv", "attn.bk", "attn.bv")


class MeshPar:
    """The mesh hooks the model code calls (``par``)."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh
        shape, c = mesh.shape, mesh.coord()
        self.dp_group = mesh.group(DP_AXES)
        self.data_weight = 1.0        # this rank's share of the batch rows
        self.tp_group = mesh.group(("model",))
        self.tp = shape.get("model", 1)
        self.tp_index = c.get("model", 0)
        self.shard_group = mesh.group(("model", "expert"))
        self.ep = shape.get("expert", 1)
        self.ep_index = c.get("expert", 0)

    def enter_tp(self, x):
        return comm.enter(x, self.tp_group)

    def exit_tp(self, x):
        return comm.leave(x, self.tp_group)

    def sum_tp(self, x):
        """A row-parallel product that every rank then uses on its own
        channels only: summed over ``"model"`` forward and backward."""
        return comm.weighted_sum(x, self.tp_group, 1.0)

    def gather_tp(self, x):
        """The rank's channels (last dim) gathered over ``"model"``; the
        backward keeps the sum of every rank's gradient on them."""
        n = x.shape[-1]
        return comm.gather_sum(x, self.tp_group, x.dim() - 1,
                               [n] * self.tp)

    def head_offset(self, local_heads: int) -> int:
        return self.tp_index * local_heads

    def enter_shard(self, x):
        return comm.enter(x, self.shard_group)

    def exit_shard(self, x):
        return comm.leave(x, self.shard_group)

    def batch_mean(self, x):
        return comm.weighted_sum(x, self.dp_group, self.data_weight)

    def expert_range(self, num_experts: int):
        per = num_experts // self.ep
        return self.ep_index * per, per


def check_mesh_config(cfg: ModelConfig, mesh: Mesh) -> None:
    """The layouts the mesh step computes: ``"model"`` divides the
    (padded) q heads, ``d_ff``, the SSM channels and the RG-LRU width;
    ``"expert"`` the experts.  The kv heads may be any count (stored
    whole where ``"model"`` does not divide them)."""
    shape = mesh.shape
    tp, ep = shape.get("model", 1), shape.get("expert", 1)
    kinds = set(cfg.layer_kinds())
    widths = {"q heads": cfg.effective_num_heads, "d_ff": cfg.d_ff,
              "SSM channels": cfg.d_inner if SSM in kinds else 0,
              "RG-LRU width": ((cfg.lru_width or cfg.d_model)
                               if REC in kinds else 0)}
    bad = [k for k, n in widths.items() if n % tp]
    if bad:
        raise ValueError(f"{cfg.name}: tp={tp} must divide the "
                         f"{', '.join(bad)}")
    if ep > 1 and (not cfg.num_experts or cfg.num_experts % ep):
        raise ValueError(f"{cfg.name}: ep={ep} must divide the experts")


def kv_heads(cfg: ModelConfig, tp: int, tp_index: int) -> List[int]:
    """The kv head of each of the rank's q heads (``tp_index`` of ``tp``),
    padded heads included: q head h reads kv head h // (He / K)."""
    he, k = cfg.effective_num_heads, max(cfg.num_kv_heads, 1)
    hl = he // tp
    return [(tp_index * hl + j) // (he // k) for j in range(hl)]


def _take_kv(x: torch.Tensor, ids: List[int]) -> torch.Tensor:
    """The kv heads ``ids`` (dim -2) of a whole kv leaf: one slice where
    the rank's q heads fall in equal consecutive groups (the flash
    kernel's GQA), else one head per q head (slices, so the gradient
    adds up without an accumulating scatter)."""
    dim = x.dim() - 2
    uniq = sorted(set(ids))
    r = len(ids) // len(uniq)
    if ids == [u for u in uniq for _ in range(r)] and \
            uniq == list(range(uniq[0], uniq[0] + len(uniq))):
        return x.narrow(dim, uniq[0], len(uniq))
    return torch.cat([x.narrow(dim, i, 1) for i in ids], dim=dim)


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
    """The rank's local parameter shards gathered over ``"data"`` (their
    gradients summed over ``"pod"`` too), the vocab leaves gathered over
    ``"model"``, the whole kv leaves cut to the rank's kv heads and a
    Mamba ``in_proj`` to its x and z channels (module docstring), cast
    to the compute dtype inside the autograd graph, in the train layout
    (never a shard itself: a view where nothing is gathered)."""
    data_group = mesh.group(("data",))
    pod_group = mesh.group(("pod",))
    tp_group = mesh.group(("model",))
    sizes = mesh.shape
    tp, ti = sizes.get("model", 1), mesh.coord().get("model", 0)
    kv_ids = kv_heads(cfg, tp, ti) if cfg.num_kv_heads else []
    cd = cfg.dtype
    out = []
    for (name, x), sh in zip(flatten_named(params), leaves(shardings)):
        if (x.dtype == torch.float32 and cd != torch.float32
                and name.rsplit(".", 1)[-1] not in _KEEP_FP32):
            x = x.to(cd)
        axes = sh.dim_axes(x.ndim)
        gshape = shapes["params." + name]
        ddim = next((i for i, a in enumerate(axes) if "data" in a), None)
        mdim = next((i for i, a in enumerate(axes) if "model" in a), None)
        dsz = (leaf_sizes(gshape[ddim], sizes.get("data", 1))
               if ddim is not None else ())
        x = comm.enter(x, pod_group)
        x = comm.gather_sum(x, data_group, ddim, dsz)
        if name in _VOCAB_LEAVES and mdim is not None:
            x = comm.gather_slice(x, tp_group, mdim,
                                  leaf_sizes(gshape[mdim], tp))
        elif (name.endswith(_KV_LEAVES) and tp > 1
              and cfg.num_kv_heads % tp):
            x = _take_kv(comm.enter(x, tp_group), kv_ids)
        elif name.endswith("ssm.in_proj") and tp > 1:
            x = comm.gather_sum(x, tp_group, mdim,
                                leaf_sizes(gshape[mdim], tp))
            di = gshape[mdim] // 2
            c0, n = ti * (di // tp), di // tp
            x = torch.cat([x.narrow(mdim, c0, n),
                           x.narrow(mdim, di + c0, n)], dim=mdim)
        out.append(x.view_as(x))
    return unflatten(params, out)


def _rows(batch: Dict[str, torch.Tensor], a: int, b: int
          ) -> Dict[str, torch.Tensor]:
    """Rows ``[a, b)`` of a batch: ``positions`` (3, B, S) along axis 1,
    every other key along axis 0."""
    return {k: (x[:, a:b] if k == "positions" else x[a:b])
            for k, x in batch.items()}


class _Run:
    """One step's work in flight (``MeshTrainStep.begin``)."""


class MeshTrainStep:
    """``train_step(state, batch) -> (state, metrics)`` over the calling
    rank's shards of the train state (``make_mesh_train_step``).  A call
    is ``begin`` (the rank's rows, one gather of the weights),
    ``microbatch`` for each microbatch (forward and backward, the
    gradients of the gathered weights summed), ``reduce`` (back through
    the gathers to the rank's shards) and ``update`` (the loss and norm
    sums, clipping and AdamW): the dry run (``launch/dryrun.py``) traces
    them one at a time."""

    def __init__(self, cfg: ModelConfig, mesh: Mesh, shardings, like, *,
                 peak_lr: float, warmup_steps: int, total_steps: int,
                 weight_decay: float, clip_norm: float, microbatches: int,
                 donate: bool, impl: Optional[str] = None):
        check_mesh_config(cfg, mesh)
        self.cfg, self.mesh, self.impl = cfg, mesh, impl
        self.lr_fn = cosine_schedule(peak_lr, warmup_steps, total_steps)
        self.weight_decay, self.clip_norm = weight_decay, clip_norm
        self.microbatches, self.donate = microbatches, donate
        self.par = MeshPar(mesh)
        self.shapes = {n: tuple(x.shape) for n, x in flatten_named(like)}
        self.p_shard = shardings["params"]
        coord, shape = mesh.coord(), mesh.shape
        self.dp = shape.get("pod", 1) * shape.get("data", 1)
        self.dp_index = (coord.get("pod", 0) * shape.get("data", 1)
                         + coord.get("data", 0))
        self.dp_group = mesh.group(DP_AXES)
        self.world_group = mesh.group(mesh.axis_names)
        self.replica0 = [sh.replica_id() == 0
                         for sh in leaves(self.p_shard)]

    def _local_loss(self, gathered, rows, weight):
        cfg = self.cfg
        weights = _train_weights(cfg, gathered)
        inputs = {k: x for k, x in rows.items() if k != "targets"}
        logits, aux = _forward_train(cfg, None, inputs, impl=self.impl,
                                     par=self.par, weights=weights)
        nll = causal_nll(cfg, logits, rows["targets"])
        loss = nll + AUX_WEIGHT * aux
        return loss * weight, nll * weight, aux * weight

    def begin(self, state, batch) -> _Run:
        run = _Run()
        dev = run.dev = state["step"].device
        batch = {k: (x if isinstance(x, torch.Tensor)
                     else torch.from_numpy(np.array(x))).to(dev)
                 for k, x in batch.items()}
        B = batch["targets"].shape[0]
        a, b = even_spans(B, self.dp)[self.dp_index]
        run.rows = _rows(batch, a, b)
        n = run.n = b - a
        if n % self.microbatches:
            raise ValueError(f"{n} local rows not divisible by "
                             f"{self.microbatches} microbatches")
        run.mb = n // self.microbatches
        run.B = B
        self.par.data_weight = n / B
        params = state["params"]
        with deterministic_algorithms(dev):
            run.live = [p.detach().requires_grad_(True)
                        for p in leaves(params)]
            # one gather a step, shared by the microbatches ...
            run.gathered = leaves(gather_weights(
                self.cfg, unflatten(params, run.live), self.p_shard,
                self.shapes, self.mesh))
        run.use = [g.detach().requires_grad_(True) for g in run.gathered]
        run.use_tree = unflatten(params, run.use)
        run.acc = None
        run.sums = torch.zeros(3, dtype=torch.float32, device=dev)
        return run

    def microbatch(self, run: _Run, i: int) -> None:
        rows = _rows(run.rows, i * run.mb, (i + 1) * run.mb)
        with deterministic_algorithms(run.dev):
            loss, nll, aux = self._local_loss(
                run.use_tree, rows, run.n / run.B / self.microbatches)
            g_ = torch.autograd.grad(loss, run.use)
            run.sums += torch.stack([loss.detach(), nll.detach(),
                                     aux.detach()])
            if run.acc is None:
                run.acc = list(g_)
            else:                       # in the gathered weights' dtype
                for a_, g in zip(run.acc, g_):
                    a_.add_(g)

    def reduce(self, run: _Run) -> List[torch.Tensor]:
        """... and one reduction: back through the gathers (the FSDP
        gradient sums) to the rank's shards."""
        del run.use, run.use_tree
        with deterministic_algorithms(run.dev):
            grads = list(torch.autograd.grad(run.gathered, run.live,
                                             grad_outputs=run.acc))
        del run.acc, run.gathered, run.live
        return grads

    def update(self, state, run: _Run, grads: List[torch.Tensor]):
        dev = run.dev
        params = state["params"]
        with deterministic_algorithms(dev):
            # the rows' weighted means summed over DP: the batch mean
            sums = comm.ordered_sum(run.sums, self.dp_group)
            sq = torch.zeros((), dtype=torch.float32, device=dev)
            for g, r0 in zip(grads, self.replica0):
                if r0:
                    sq = sq + torch.sum(g.to(torch.float32) ** 2)
            gnorm = torch.sqrt(comm.ordered_sum(sq, self.world_group))
            scale = torch.clamp(torch.full_like(gnorm, self.clip_norm)
                                / torch.clamp_min(gnorm, 1e-12), max=1.0)
            lr = self.lr_fn(state["step"])
            if self.donate:
                adamw_update_(grads, state["opt"], params, lr=lr,
                              scale=scale, weight_decay=self.weight_decay)
                new_params, new_opt = params, state["opt"]
            else:
                new_params, new_opt = adamw_update(
                    grads, state["opt"], params, lr=lr, scale=scale,
                    weight_decay=self.weight_decay)
        new_state = {"step": state["step"] + 1, "params": new_params,
                     "opt": new_opt, "rng": next_rng(state["rng"])}
        loss, nll, aux = sums[0], sums[1], sums[2]
        finite = torch.isfinite(loss) & torch.isfinite(gnorm)
        out: Dict[str, Any] = {
            "loss": loss, "grad_norm": gnorm, "lr": lr,
            "nonfinite": (~finite).to(torch.float32), "nll": nll,
            "aux": aux}
        return new_state, out

    def __call__(self, state, batch):
        run = self.begin(state, batch)
        for i in range(self.microbatches):
            self.microbatch(run, i)
        return self.update(state, run, self.reduce(run))


def make_mesh_train_step(cfg: ModelConfig, mesh: Mesh, shardings,
                         like, *, peak_lr: float = 3e-4,
                         warmup_steps: int = 100, total_steps: int = 10_000,
                         weight_decay: float = 0.1, clip_norm: float = 1.0,
                         microbatches: int = 1,
                         donate: bool = False) -> MeshTrainStep:
    """``train_step(state, batch) -> (state, metrics)`` over the calling
    rank's shards of the train state.  ``shardings``: the state's
    ``NamedSharding`` tree on ``mesh`` (``sharding.rules.state_specs``
    resolved); ``like``: a tree of the state's global shapes (e.g.
    ``init_state(cfg, device="meta")``).  ``batch``: the global batch
    (every rank sees the same); the rank takes its DP rows.

    ``donate``: the step consumes the given state, as JAX's donated
    arguments: AdamW updates its leaves in place (``adamw_update_``), so
    a rank holds a few temporaries of one leaf at the update, not a
    second state (ranks sharing one card each keep their own allocator's
    peak).  Without it the same update runs on copies and the given state
    stays intact."""
    return MeshTrainStep(cfg, mesh, shardings, like, peak_lr=peak_lr,
                         warmup_steps=warmup_steps, total_steps=total_steps,
                         weight_decay=weight_decay, clip_norm=clip_norm,
                         microbatches=microbatches, donate=donate)


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
    combos = [("model", "expert"), tuple(mesh.axis_names)]
    if "pod" in mesh.axis_names:
        combos.append(DP_AXES)
    return combos


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
