"""Batched serving: prefill a prompt batch, decode greedily (the port's
twin of the reference's ``examples/serve_lm.py``; mixtral-8x7b by
default).

    PYTHONPATH=src python -m repro_torch.launch.serve_lm --tiny --device cpu

A lockstep batch: one B-row prefill fills ``init_cache(cfg, B,
prompt_len + gen)``, then ``make_decode_step`` advances every row one
token a step.  The model runs on the card unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
import time
from typing import Dict

import torch

from repro_torch.configs import ALL_ARCHS
from repro_torch.device import resolve_device
from repro_torch.models import get_config, init_cache, init_params
from repro_torch.train import make_decode_step, make_prefill_step


def generate(cfg, params, prompts: torch.Tensor, gen: int,
             device) -> Dict:
    """Prefill ``prompts`` (B, L) and decode ``gen - 1`` more tokens
    greedily: {"tokens": (B, gen) int32, "prefill_s", "decode_s"}."""
    B, L = prompts.shape
    cache = init_cache(cfg, B, L + gen, device)
    prefill = make_prefill_step(cfg)
    decode = make_decode_step(cfg)

    def sync():
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()

    with torch.no_grad():
        t0 = time.perf_counter()
        tok, cache = prefill(params, {"tokens": prompts}, cache)
        sync()
        t_prefill = time.perf_counter() - t0
        out = [tok]
        t0 = time.perf_counter()
        for _ in range(gen - 1):
            tok, cache = decode(params, {"tokens": tok[:, None]}, cache)
            out.append(tok)
        sync()
        t_decode = time.perf_counter() - t0
    return {"tokens": torch.stack(out, dim=1), "prefill_s": t_prefill,
            "decode_s": t_decode}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mixtral-8x7b", choices=ALL_ARCHS)
    ap.add_argument("--tiny", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the depth (0: as configured)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=24)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch, tiny=args.tiny)
    if not cfg.has_decode or cfg.embedding_inputs:
        print(f"{args.arch} has no decode loop over token prompts "
              "(encoder-only or embedding inputs)")
        return 1
    if args.layers:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    params = init_params(cfg, seed=args.seed, device=device)
    gen_ = torch.Generator(device="cpu")
    gen_.manual_seed(args.seed + 1)
    prompts = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                            generator=gen_, dtype=torch.int32).to(device)
    out = generate(cfg, params, prompts, args.gen, device)
    B, L, g = args.batch, args.prompt_len, args.gen
    print(f"prefill: {B}x{L} tokens in {out['prefill_s']*1e3:.1f} ms "
          f"({B*L/out['prefill_s']:.0f} tok/s)")
    print(f"decode:  {B}x{g-1} tokens in {out['decode_s']*1e3:.1f} ms "
          f"({B*(g-1)/max(out['decode_s'], 1e-9):.0f} tok/s)")
    print("generated ids[0]:", out["tokens"][0].tolist())
    return 0


if __name__ == "__main__":
    sys.exit(main())
