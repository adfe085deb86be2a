"""Optimizer (twin of ``repro.optim``)."""
from repro_torch.optim.adamw import (AdamWConfig, OptState, adamw_update,
                                     global_norm, init_opt_state, warmup_cosine)

__all__ = ["AdamWConfig", "OptState", "adamw_update", "global_norm",
           "init_opt_state", "warmup_cosine"]
