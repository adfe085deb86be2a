"""Model substrate (dense, MoE, Mamba-2 and hybrid decoders): layers,
attention, MoE FFN, the Mamba-2 mixer, decoder stack."""
from repro_torch.models import mamba2
from repro_torch.models.transformer import (cache_defs, decode_step,
                                            forward_train, loss_fn,
                                            model_defs, n_groups, period,
                                            prefill)

__all__ = ["mamba2", "model_defs", "cache_defs", "forward_train", "loss_fn",
           "prefill", "decode_step", "period", "n_groups"]
