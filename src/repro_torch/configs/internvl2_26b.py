"""InternVL2-26B — InternViT frontend (stubbed: patch embeddings provided)
+ InternLM2-20B LM backbone.  [arXiv:2404.16821; hf]."""
from repro_torch.configs.base import ModelConfig, tiny_variant

CONFIG = ModelConfig(
    name="internvl2_26b", n_layers=48, d_model=6144, n_heads=48,
    n_kv_heads=8, head_dim=128, d_ff=16384, vocab_size=92553,
    modality="vlm",
)
SMOKE = tiny_variant(CONFIG)
