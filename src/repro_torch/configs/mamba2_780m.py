"""Mamba2-780m — attention-free SSD (state-space duality).
[arXiv:2405.21060; unverified].  48 layers, d_model 1536, no FFN
(d_ff=0: the mamba block IS the layer), d_state 128, head_dim 64."""
from repro_torch.configs.base import ModelConfig, tiny_variant

CONFIG = ModelConfig(
    name="mamba2_780m", family="ssm", n_layers=48, d_model=1536,
    n_heads=1, n_kv_heads=1, d_ff=0, vocab_size=50280,
    ssm_state=128, ssm_head_dim=64, ssm_expand=2, tie_embeddings=True,
)
SMOKE = tiny_variant(CONFIG, d_ff=0)
