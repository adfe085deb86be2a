"""Architecture configs: one module per arch (CONFIG + SMOKE), all ten of
the reference's."""
from repro_torch.configs.base import (ARCH_IDS, SHAPES, ModelConfig, ShapeSpec,
                                      get_config, get_smoke_config, tiny_variant)

__all__ = ["ARCH_IDS", "SHAPES", "ModelConfig", "ShapeSpec", "get_config",
           "get_smoke_config", "tiny_variant"]
