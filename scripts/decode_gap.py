#!/usr/bin/env python3
"""How far a deep stack's decode drifts from its full forward on one CUDA
card, and where the drift comes from.

    python3 scripts/decode_gap.py [--seed N]

qwen2-vl-2b at full width (28 layers, random weights from ``--seed``):
chip_smoke.py's ``serve-families`` inputs (a batch of 2: 64 text
embeddings, a 24 x 24 patch image with its (t, h, w) M-RoPE ids, 16
text embeddings) prefilled into a lockstep cache, then 4 decode steps.
Each step's logits are compared with a full forward's last position,
as the largest absolute difference over the full forward's largest
magnitude:

* in bfloat16 and in float32;
* two full forwards of n and n + 1 positions at position n - 1 (the
  GEMM shapes of prefill size alone);
* in bfloat16 with cuBLAS's reduced-precision bf16 reductions allowed
  and forbidden (``allow_bf16_reduced_precision_reduction``), each with
  the kernels, with the plain decode attention, and with the plain
  attention on both sides (decode and full forward).

Witnesses of where the bf16 gap comes from (``--part witness``), each
in bfloat16 against its own full forward:

* qwen2-vl-2b over the same embeddings with text ids (one position on
  all three M-RoPE axes: plain RoPE);
* granite-3-8b at 28 of its 40 layers over token ids (a token-input
  stack without M-RoPE), the same batch and lengths;
* both again with the decode's projections run at the prefill's M: each
  decode-step GEMM (q/k/v/o, the MLP, the logits head) gets its rows
  padded with zero rows to the prefill's B x S and sliced back, so only
  the attention route and the decode's elementwise steps differ.

Then hubert-xlarge (48 layers, 4 x 1000 frames): the encoder's forward
through the flash kernel against the same forward through the plain
attention, in bfloat16 and float32.  Prints one JSON line per reading;
``--part`` runs one group (``vl``, ``witness`` or ``hubert``).
Imports no JAX.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import chip_smoke as c  # noqa: E402
import repro_torch.layers.mlp as mlp  # noqa: E402
import repro_torch.models.transformer as tf  # noqa: E402
from repro_torch.kernels.flash_attention.ref import \
    flash_attention_ref  # noqa: E402
from repro_torch.layers.attention import decode_mha  # noqa: E402
from repro_torch.models import forward, get_config, init_params  # noqa: E402

STEPS = 4


def gap(a, b) -> float:
    return ((a.float() - b.float()).abs().max()
            / b.float().abs().max()).item()


def plain_decode(q, k, v, pos, cur, *, cache_len, window=0, softcap=0.0,
                 scale=None, table=None):
    return decode_mha(q, k, v, pos, cur, window=window, softcap=softcap,
                      scale=scale)


def full_last(cfg, params, emb, ids, n):
    with torch.no_grad():
        return forward(cfg, params, {"embeddings": emb[:, :n].cuda(),
                                     "positions": ids[:, :, :n].cuda()},
                       mode="prefill")[0].float().cpu()


def vl_gaps(cfg, params, emb, ids, S):
    got = c._vl_decode(cfg, params, emb, ids, S, "cuda")
    return [gap(got[i], full_last(cfg, params, emb, ids, S + i)[:, -1])
            for i in range(1, STEPS + 1)]


def tok_decode(cfg, params, tokens, S):
    """``chip_smoke._vl_decode`` over token ids: prefill S positions into
    a lockstep cache, then decode the rest one a step."""
    from repro_torch.models import init_cache

    B, T = tokens.shape
    tokens = tokens.cuda()
    cache = init_cache(cfg, B, T, "cuda")
    out = []
    with torch.no_grad():
        logits, cache = forward(cfg, params, {"tokens": tokens[:, :S]},
                                mode="prefill", cache=cache)
        out.append(logits[:, -1].float().cpu())
        for i in range(S, T):
            logits, cache = forward(cfg, params,
                                    {"tokens": tokens[:, i:i + 1]},
                                    mode="decode", cache=cache)
            out.append(logits[:, 0].float().cpu())
    return out


def tok_gaps(cfg, params, tokens, S):
    got = tok_decode(cfg, params, tokens, S)
    with torch.no_grad():
        return [gap(got[i], forward(cfg, params,
                                    {"tokens": tokens[:, :S + i].cuda()},
                                    mode="prefill")[0][:, -1].float().cpu())
                for i in range(1, STEPS + 1)]


class prefill_m:
    """Within the block, every projection whose input has fewer than
    ``rows`` rows runs on that input padded with zero rows to ``rows``
    (the prefill's GEMM shape), its result sliced back."""

    def __init__(self, rows: int):
        self.rows = rows

    def _pad(self, x):
        flat = x.reshape(-1, x.shape[-1])
        m = flat.shape[0]
        if m >= self.rows:
            return x, None
        return torch.cat([flat, flat.new_zeros(self.rows - m,
                                               flat.shape[1])]), (m, x.shape)

    def __enter__(self):
        self.saved = (tf.dot, mlp.dot, tf._logits_out)
        dot, _, logits_out = self.saved

        def padded_dot(x, w, impl=None):
            xp, cut = self._pad(x)
            y = dot(xp, w, impl)
            return y if cut is None else y[:cut[0]].reshape(
                *cut[1][:-1], y.shape[-1])

        def padded_logits(cfg, params, x):
            xp, cut = self._pad(x)
            y = logits_out(cfg, params, xp)
            return y if cut is None else y[:cut[0]].reshape(
                *cut[1][:-1], y.shape[-1])

        tf.dot = mlp.dot = padded_dot
        tf._logits_out = padded_logits
        return self

    def __exit__(self, *exc):
        tf.dot, mlp.dot, tf._logits_out = self.saved


def witness(seed: int) -> None:
    """The bf16 decode-vs-full gap without M-RoPE ids and on a
    token-input stack, each with and without the prefill's GEMM shape."""
    cfg = get_config("qwen2-vl-2b")
    params = init_params(cfg, seed=seed, device="cuda")
    emb, ids, S = c._vl_inputs(cfg, 2, c.VL_TEXT, c.VL_GRID, c.VL_TAIL,
                               STEPS, seed)
    text = torch.arange(ids.shape[2], dtype=ids.dtype)
    text_ids = text[None, None].expand(3, ids.shape[1], -1).contiguous()
    for name, pos in (("mrope_ids", ids), ("text_ids", text_ids)):
        for padded in (False, True):
            if padded:
                with prefill_m(2 * S):
                    g = vl_gaps(cfg, params, emb, pos, S)
            else:
                g = vl_gaps(cfg, params, emb, pos, S)
            print(json.dumps({"model": cfg.name, "dtype": "torch.bfloat16",
                              "positions": name,
                              "projections_at_prefill_m": padded,
                              "decode_vs_full": g}), flush=True)
    del params
    torch.cuda.empty_cache()
    cfg = dataclasses.replace(get_config("granite-3-8b"), num_layers=28)
    params = init_params(cfg, seed=seed, device="cuda")
    tokens = torch.randint(0, cfg.vocab_size, (2, S + STEPS),
                           generator=torch.Generator().manual_seed(seed))
    for padded in (False, True):
        if padded:
            with prefill_m(2 * S):
                g = tok_gaps(cfg, params, tokens, S)
        else:
            g = tok_gaps(cfg, params, tokens, S)
        print(json.dumps({"model": cfg.name, "layers": cfg.num_layers,
                          "dtype": "torch.bfloat16", "inputs": "tokens",
                          "prefill_len": S, "projections_at_prefill_m": padded,
                          "decode_vs_full": g}), flush=True)
    del params
    torch.cuda.empty_cache()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--part", choices=("all", "vl", "witness", "hubert"),
                    default="all")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("decode_gap.py: needs a CUDA device", file=sys.stderr)
        return 1
    c.phase_card()
    c.phase_build()
    kernels = (tf.flash_attention, tf.row_decode_attention)
    if args.part in ("all", "witness"):
        witness(args.seed)
    for dtype in ((torch.bfloat16, torch.float32)
                  if args.part in ("all", "vl") else ()):
        cfg = dataclasses.replace(get_config("qwen2-vl-2b"), dtype=dtype)
        params = init_params(cfg, seed=args.seed, device="cuda")
        emb, ids, S = c._vl_inputs(cfg, 2, c.VL_TEXT, c.VL_GRID, c.VL_TAIL,
                                   STEPS, args.seed)
        shapes = [gap(full_last(cfg, params, emb, ids, n)[:, n - 1],
                      full_last(cfg, params, emb, ids, n + 1)[:, n - 1])
                  for n in range(S, S + STEPS)]
        print(json.dumps({"model": cfg.name, "dtype": str(dtype),
                          "decode_vs_full": vl_gaps(cfg, params, emb, ids,
                                                    S),
                          "full_n_vs_n1": shapes}), flush=True)
        if dtype == torch.bfloat16:
            for reduced in (True, False):
                torch.backends.cuda.matmul\
                    .allow_bf16_reduced_precision_reduction = reduced
                for plain in ("none", "decode", "both"):
                    if plain != "none":
                        tf.row_decode_attention = plain_decode
                    if plain == "both":
                        tf.flash_attention = flash_attention_ref
                    try:
                        g = vl_gaps(cfg, params, emb, ids, S)
                    finally:
                        tf.flash_attention, tf.row_decode_attention = \
                            kernels
                    print(json.dumps({
                        "model": cfg.name, "dtype": str(dtype),
                        "bf16_reduced_reduction": reduced,
                        "plain_attention": plain, "decode_vs_full": g}),
                        flush=True)
            torch.backends.cuda.matmul\
                .allow_bf16_reduced_precision_reduction = True
        del params
        torch.cuda.empty_cache()
    for dtype in ((torch.bfloat16, torch.float32)
                  if args.part in ("all", "hubert") else ()):
        cfg = dataclasses.replace(get_config("hubert-xlarge"), dtype=dtype)
        params = init_params(cfg, seed=args.seed, device="cuda")
        x = torch.randn(c.HUBERT_BATCH, c.HUBERT_FRAMES, cfg.d_model,
                        generator=torch.Generator().manual_seed(args.seed)
                        ).cuda()
        with torch.no_grad():
            got = forward(cfg, params, {"embeddings": x}, mode="prefill")[0]
            tf.flash_attention = flash_attention_ref
            try:
                want = forward(cfg, params, {"embeddings": x},
                               mode="prefill")[0]
            finally:
                tf.flash_attention = kernels[0]
        print(json.dumps({"model": cfg.name, "dtype": str(dtype),
                          "kernel_vs_plain_attention": gap(got, want)}),
              flush=True)
        del params
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
