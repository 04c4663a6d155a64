"""Training and serving steps."""
from repro_torch.train.serve import (logit_stats, make_paged_decode_step,
                                     make_prefill_step)
from repro_torch.train.state import TrainState, init_state
from repro_torch.train.step import loss_fn, make_train_step

__all__ = ["TrainState", "init_state", "loss_fn", "make_train_step",
           "logit_stats", "make_paged_decode_step", "make_prefill_step"]
