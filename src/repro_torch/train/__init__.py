"""Serving steps (the training step waits for its slice)."""
from repro_torch.train.serve import (logit_stats, make_paged_decode_step,
                                     make_prefill_step)

__all__ = ["logit_stats", "make_paged_decode_step", "make_prefill_step"]
