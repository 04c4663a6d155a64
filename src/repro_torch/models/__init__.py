"""Model configs and the decoder stack (attention and Mamba-1 layers)."""
from repro_torch.models.base import (BIDIR, FULL, LOCAL, REC, SSM,
                                     ModelConfig, get_config, list_archs,
                                     register)
from repro_torch.models.convert import params_from_jax, state_from_jax
from repro_torch.models.transformer import (forward, init_cache,
                                            init_paged_cache, init_params,
                                            init_train_params, load_weight)

__all__ = ["BIDIR", "FULL", "LOCAL", "REC", "SSM", "ModelConfig",
           "get_config", "list_archs", "register", "params_from_jax",
           "state_from_jax", "forward", "init_cache", "init_paged_cache",
           "init_params", "init_train_params", "load_weight"]
