"""Train step: loss, grads (with optional microbatch accumulation), clip,
AdamW update — the reference's ``train/step.py``.  One step is one BSP
superstep.

On the card the step runs under ``device.deterministic_algorithms``:
with the port's deterministic kernels and a fixed cuBLAS workspace, the
same state and batch give the same bits, which fail-stop recovery needs
(a recovered run equals an uninterrupted one)."""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import deterministic_algorithms
from repro_torch.layers.attention import NEG_INF
from repro_torch.models.base import ModelConfig
from repro_torch.models.transformer import forward
from repro_torch.optim import (adamw_update, clip_by_global_norm,
                               cosine_schedule)
from repro_torch.train.state import next_rng
from repro_torch.tree import leaves, unflatten

AUX_WEIGHT = 0.01


def loss_fn(cfg: ModelConfig, params, batch: Dict[str, torch.Tensor],
            impl: Optional[str] = None
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Causal-LM (or frame-classification: hubert's cluster targets)
    cross entropy over the padded vocab (padded logits masked to
    ``NEG_INF``), in float32, plus ``AUX_WEIGHT`` x the MoE
    load-balancing loss.  ``impl="abft"``: checksummed projections (SDC
    tier 1)."""
    logits, aux = forward(cfg, params, batch, mode="train", impl=impl)
    nll = causal_nll(cfg, logits, batch["targets"])
    return nll + AUX_WEIGHT * aux, {"nll": nll, "aux": aux}


def causal_nll(cfg: ModelConfig, logits: torch.Tensor,
               targets: torch.Tensor) -> torch.Tensor:
    """Mean cross entropy of ``logits`` (B, S, padded vocab) against
    ``targets``, the padded columns masked out."""
    logits = logits.to(torch.float32)
    v, vp = cfg.vocab_size, cfg.padded_vocab
    if vp > v:
        pad = torch.arange(vp, device=logits.device) >= v
        logits = torch.where(pad, NEG_INF, logits)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.take_along_dim(logits, targets.long()[..., None],
                                dim=-1)[..., 0]
    return torch.mean(logz - gold)


def split_microbatches(batch: Dict[str, torch.Tensor],
                       microbatches: int) -> List[Dict[str, torch.Tensor]]:
    """The reference's ``resplit``: ``microbatches`` consecutive row
    blocks of the batch, its size read from ``targets``; ``positions``
    (3, B, S) split along axis 1, every other key along axis 0."""
    B = batch["targets"].shape[0]
    if B % microbatches:
        raise ValueError(f"batch dim {B} not divisible by {microbatches}")
    b = B // microbatches
    return [{k: (x[:, i * b:(i + 1) * b] if k == "positions"
                 else x[i * b:(i + 1) * b]) for k, x in batch.items()}
            for i in range(microbatches)]


def make_train_step(cfg: ModelConfig, *, peak_lr: float = 3e-4,
                    warmup_steps: int = 100, total_steps: int = 10_000,
                    weight_decay: float = 0.1, clip_norm: float = 1.0,
                    microbatches: int = 1,
                    impl: Optional[str] = None) -> Callable:
    """Returns ``train_step(state, batch) -> (state, metrics)``.

    ``batch``: ``tokens`` (or ``embeddings`` (B, S, D) for an
    embedding-input stack) and ``targets`` (B, S), under M-RoPE
    ``positions`` (3, B, S), tensors or numpy arrays on any device (moved
    to the state's).  With ``microbatches`` > 1 the batch is split along
    B (``split_microbatches``), the microbatch gradients are summed in
    order and scaled by ``1 / microbatches``.  ``impl="abft"`` runs the
    projection matmuls, forward and backward, through the checksummed
    kernel.  The step is functional: it returns a new state and leaves
    the given one intact."""
    lr_fn = cosine_schedule(peak_lr, warmup_steps, total_steps)

    def grads_of(params, live, batch):
        loss, metrics = loss_fn(cfg, params, batch, impl)
        grads = torch.autograd.grad(loss, live)
        return (loss.detach(), {k: m.detach() for k, m in metrics.items()},
                list(grads))

    def train_step(state, batch):
        dev = state["step"].device
        rng = next_rng(state["rng"])
        batch = {k: (x if isinstance(x, torch.Tensor)
                     else torch.from_numpy(np.array(x))).to(dev)
                 for k, x in batch.items()}
        params = state["params"]
        with deterministic_algorithms(dev):
            live = [p.detach().requires_grad_(True) for p in leaves(params)]
            live_params = unflatten(params, live)
            if microbatches > 1:
                loss = metrics = grads = None
                for mb in split_microbatches(batch, microbatches):
                    l_, m_, g_ = grads_of(live_params, live, mb)
                    if grads is None:
                        loss, metrics, grads = l_, m_, g_
                    else:
                        loss = loss + l_
                        metrics = {k: metrics[k] + m_[k] for k in metrics}
                        for acc, g in zip(grads, g_):
                            acc.add_(g)
                inv = 1.0 / microbatches
                loss = loss * inv
                metrics = {k: m * inv for k, m in metrics.items()}
                grads = [g * inv for g in grads]
            else:
                loss, metrics, grads = grads_of(live_params, live, batch)
            del live, live_params
            grads, gnorm = clip_by_global_norm(unflatten(params, grads),
                                               clip_norm)
            lr = lr_fn(state["step"])
            new_params, new_opt = adamw_update(
                grads, state["opt"], params, lr=lr,
                weight_decay=weight_decay)
        new_state = {"step": state["step"] + 1, "params": new_params,
                     "opt": new_opt, "rng": rng}
        finite = torch.isfinite(loss) & torch.isfinite(gnorm)
        out: Dict[str, Any] = {
            "loss": loss, "grad_norm": gnorm, "lr": lr,
            "nonfinite": (~finite).to(torch.float32), **metrics}
        return new_state, out

    return train_step


def metrics_to_host(metrics: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """One device-to-host copy for every scalar metric of a step (the end
    of the superstep)."""
    names: List[str] = list(metrics)
    vals = torch.stack([torch.as_tensor(metrics[k]).to(torch.float32)
                        .reshape(()) for k in names]).tolist()
    return dict(zip(names, vals))
