"""DeepSeek-67B — dense llama-arch, GQA kv=8.  [arXiv:2401.02954; hf]."""
from repro_torch.configs.base import ModelConfig, tiny_variant

CONFIG = ModelConfig(
    name="deepseek_67b", n_layers=95, d_model=8192, n_heads=64, n_kv_heads=8,
    head_dim=128, d_ff=22016, vocab_size=102400,
)
SMOKE = tiny_variant(CONFIG)
