"""TrainState: the DeLIA *global state*, a plain tree of tensors so the
checkpoint layer treats it generically.  The reference's layout leaf for
leaf: ``step`` (int32), ``params`` (float32 master weights, stacked
blocks), ``opt`` (AdamW ``m``, ``v``, ``count``) and ``rng`` (the
reference's uint32 key pair)."""
from __future__ import annotations

from typing import Any, Dict, Sequence

import torch

from repro_torch.device import resolve_device
from repro_torch.models.base import ModelConfig
from repro_torch.models.transformer import init_train_params
from repro_torch.optim import adamw_init
from repro_torch.prng import fold_in, prng_key

TrainState = Dict[str, Any]


def key_tensor(words: Sequence[int], device) -> torch.Tensor:
    return torch.tensor([int(w) for w in words], dtype=torch.uint32,
                        device=device)


def next_rng(rng: torch.Tensor) -> torch.Tensor:
    """``jax.random.fold_in(rng, 1)``, as the reference's step advances
    its key (computed on the host: two words)."""
    return key_tensor(fold_in(rng.tolist(), 1), rng.device)


def init_state(cfg: ModelConfig, *, seed: int = 0,
               device=None) -> TrainState:
    """Fresh state on ``device`` (``None`` = the card): parameters from
    ``seed`` (a ``torch.Generator``), zero moments, the reference's
    ``PRNGKey(0)``."""
    device = resolve_device(device)
    params = init_train_params(cfg, seed=seed, device=device)
    return {
        "step": torch.zeros((), dtype=torch.int32, device=device),
        "params": params,
        "opt": adamw_init(params),
        "rng": key_tensor(prng_key(0), device),
    }
