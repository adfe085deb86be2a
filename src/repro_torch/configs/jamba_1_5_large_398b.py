"""Jamba-1.5-Large (398B, A94B) — hybrid Mamba+attention 1:7, MoE 16e top-2.

[arXiv:2403.19887 / 2408.12570; hf].  72 layers, d_model 8192, 64 heads
(GQA kv=8), d_ff 24576, vocab 65536.  One attention layer per 8 (1:7), MoE
FFN every 2 layers.  Mamba layers use d_state 16 per the Jamba paper (the mixer is
the SSD / Mamba-2 form, as in the reference config).
"""
from repro_torch.configs.base import ModelConfig, tiny_variant

CONFIG = ModelConfig(
    name="jamba_1_5_large_398b",
    family="hybrid",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=24576,
    vocab_size=65536,
    n_experts=16,
    top_k=2,
    moe_every=2,
    attn_every=8,
    ssm_state=16,
    ssm_head_dim=64,
    ssm_expand=2,
    rope_theta=1e6,
)

SMOKE = tiny_variant(CONFIG)
