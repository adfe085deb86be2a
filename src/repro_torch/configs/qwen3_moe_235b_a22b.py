"""Qwen3-235B-A22B — MoE 128 experts top-8, GQA kv=4, head_dim 128
(decoupled from d_model).  [hf:Qwen/Qwen3-235B-A22B; d_ff is the
per-expert intermediate size]."""
from repro_torch.configs.base import ModelConfig, tiny_variant

CONFIG = ModelConfig(
    name="qwen3_moe_235b_a22b", n_layers=94, d_model=4096, n_heads=64,
    n_kv_heads=4, head_dim=128, d_ff=1536, vocab_size=151936,
    n_experts=128, top_k=8, family="moe", rope_theta=1e6,
)
SMOKE = tiny_variant(CONFIG)
