"""Moonlight-16B-A3B (moonshot) — MoE 64 experts top-6.
[hf:moonshotai/Moonlight-16B-A3B; simplified: no shared expert, as in the
reference config]."""
from repro_torch.configs.base import ModelConfig, tiny_variant

CONFIG = ModelConfig(
    name="moonshot_v1_16b_a3b", n_layers=48, d_model=2048, n_heads=16,
    n_kv_heads=16, d_ff=1408, vocab_size=163840, n_experts=64, top_k=6,
    family="moe",
)
SMOKE = tiny_variant(CONFIG)
