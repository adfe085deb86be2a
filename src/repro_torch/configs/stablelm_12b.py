"""StableLM-2-12B — dense, GQA kv=8.  [hf:stabilityai/stablelm-2-12b]."""
from repro_torch.configs.base import ModelConfig, tiny_variant

CONFIG = ModelConfig(
    name="stablelm_12b", n_layers=40, d_model=5120, n_heads=32, n_kv_heads=8,
    d_ff=13824, vocab_size=100352,
)
SMOKE = tiny_variant(CONFIG)
