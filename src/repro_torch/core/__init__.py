"""StruM core (PyTorch twin of ``repro.core``): blocking, set quantizers,
Fig.-5 packing, policy and the per-array transforms."""
from repro_torch.core.apply import (fake_quantize_array, pack_array,
                                    packed_payload_bytes, unpack_array)
from repro_torch.core.packing import (PackedStruM, compression_ratio,
                                      compression_ratio_sparsity, dequantize, pack)
from repro_torch.core.policy import (DEFAULT_EXCLUDE, LayerPolicy, StruMConfig,
                                     default_policy, q_for_L)
from repro_torch.core.quantizers import METHODS, int8_symmetric, quantize_blocks

__all__ = ["fake_quantize_array", "pack_array", "packed_payload_bytes",
           "unpack_array", "PackedStruM", "compression_ratio",
           "compression_ratio_sparsity", "dequantize", "pack",
           "DEFAULT_EXCLUDE", "LayerPolicy", "StruMConfig", "default_policy",
           "q_for_L", "METHODS", "int8_symmetric", "quantize_blocks"]
