from repro_torch.optim.adamw import adamw_init, adamw_update, adamw_update_
from repro_torch.optim.clip import clip_by_global_norm, global_norm
from repro_torch.optim.schedule import cosine_schedule

__all__ = ["adamw_init", "adamw_update", "adamw_update_", "clip_by_global_norm",
           "global_norm", "cosine_schedule"]
