"""Model substrate (dense and MoE decoders): layers, attention, MoE FFN,
decoder stack."""
from repro_torch.models.transformer import (decode_step, forward_train,
                                            model_defs, n_groups, period,
                                            prefill)

__all__ = ["model_defs", "forward_train", "prefill", "decode_step", "period",
           "n_groups"]
