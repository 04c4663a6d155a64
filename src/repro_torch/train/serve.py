"""Serving steps: B=1 prefill against a fresh cache row, and one batched
decode step over the block-paged pool or over the slot pool's contiguous
rows, all with greedy sampling.

``argmax`` ties go to the first index, as in the reference.  A batch
carries ``tokens``, or ``embeddings`` (B, S, D) for an embedding-input
stack (qwen2-vl's patch and text embeddings, with its (3, B, S) M-RoPE
``positions``), as ``models.transformer.forward`` takes them."""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.layers.attention import NEG_INF
from repro_torch.models.base import ModelConfig
from repro_torch.models.transformer import forward


def _mask_pad_vocab(cfg: ModelConfig, logits: torch.Tensor) -> torch.Tensor:
    if cfg.padded_vocab > cfg.vocab_size:
        logits = logits.clone()
        logits[..., cfg.vocab_size:] = NEG_INF
    return logits


def make_prefill_step(cfg: ModelConfig,
                      pad_to: Optional[int] = None) -> Callable:
    """``prefill_step(params, batch, cache) -> (next_tok (1,), cache)``.

    ``pad_to``: run every prompt at this one length (zero tokens past the
    prompt; causal attention keeps them out of every real position, and
    only the prompt's positions enter the cache).  On the card, cuBLAS
    picks its GEMM kernel — tile shape, split-K — from the shape, so two
    prompts of different lengths could compute their shared prefix's k/v
    with different summation orders.  One prefill shape keeps a prefix's
    k/v bit-identical whichever prompt computed it, which the prefix
    cache and token-identical failover retries rely on.  Token prompts
    only: an embedding-input batch runs at its own length."""
    def prefill_step(params, batch, cache):
        L = (batch["embeddings"] if cfg.embedding_inputs
             else batch["tokens"]).shape[1]
        if pad_to is not None and pad_to > L:
            if cfg.embedding_inputs:
                raise ValueError(f"{cfg.name}: embedding inputs prefill at "
                                 "their own length")
            batch = {"tokens": F.pad(batch["tokens"], (0, pad_to - L)),
                     "length": L}
        logits, cache = forward(cfg, params, batch, mode="prefill",
                                cache=cache)
        logits = _mask_pad_vocab(cfg, logits[:, L - 1].float())
        return torch.argmax(logits, dim=-1).to(torch.int32), cache

    return prefill_step


def logit_stats(cfg: ModelConfig,
                logits: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Per-row decode-path SDC signals from the last-position logits
    (B, V) fp32: a non-finite flag and the softmax entropy in nats (pad
    vocab columns are already masked to NEG_INF by the caller)."""
    nonfinite = 1.0 - torch.isfinite(logits).all(dim=-1).float()
    lse = torch.logsumexp(logits, dim=-1)
    p = torch.softmax(logits, dim=-1)
    entropy = lse - torch.where(p > 0, p * logits,
                                torch.zeros_like(p)).sum(dim=-1)
    return {"nonfinite": nonfinite, "entropy": entropy}


def make_decode_step(cfg: ModelConfig) -> Callable:
    """``decode_step(params, batch, cache) -> (next_tok (B,), cache)``:
    one token per contiguous cache row (``batch["tokens"]`` (B, 1)), the
    rows advanced in place.  Over a lockstep cache (``init_cache(cfg, B,
    cache_len)`` filled by a B-row prefill, as the reference's
    ``examples/serve_lm.py`` drives it) every row sits at the same
    position; each row keeps its own position all the same (its
    ``cache["index"]``), so the step also serves the slot pool."""
    def decode_step(params, batch, cache):
        logits, cache = forward(cfg, params, batch, mode="decode",
                                cache=cache)
        last = _mask_pad_vocab(cfg, logits[:, -1].float())
        return torch.argmax(last, dim=-1).to(torch.int32), cache

    return decode_step


def make_serve_decode_step(cfg: ModelConfig) -> Callable:
    """Decode step for the slot pool (serve/cache_pool.py): next token,
    the cache advanced in place, and the per-row logit stats the decode
    sentinel guards.  The reference vmaps its step over the pool's slot
    axis; here the slots are the batch rows of one step, each written
    and attended at its own position (attention rows) or advanced from
    its own state (Mamba rows)."""
    def decode_step(params, batch, cache):
        logits, cache = forward(cfg, params, batch, mode="decode",
                                cache=cache)
        last = _mask_pad_vocab(cfg, logits[:, -1].float())
        next_tok = torch.argmax(last, dim=-1).to(torch.int32)
        return next_tok, cache, logit_stats(cfg, last)

    return decode_step


def make_paged_decode_step(cfg: ModelConfig) -> Callable:
    """One decode step for the block-paged serving pool: every pool row
    advances one token against the shared page pool through its page
    table, in one batched call.

    batch: ``tokens`` (R, 1) last emitted token per row, ``lengths`` (R,)
    int32 the query position per row, ``page_tables`` (R, MPR) int32.
    Inactive rows carry a zeroed table + length 0 and only ever touch the
    null page; their outputs are discarded by the engine."""
    def paged_decode_step(params, batch, pages):
        logits, pages = forward(cfg, params, batch, mode="paged_decode",
                                cache=pages)
        last = _mask_pad_vocab(cfg, logits[:, -1].float())
        next_tok = torch.argmax(last, dim=-1).to(torch.int32)
        return next_tok, pages, logit_stats(cfg, last)

    return paged_decode_step
