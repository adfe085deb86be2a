"""MusicGen-medium — decoder-only over EnCodec tokens (audio).
[arXiv:2306.05284; hf].  The EnCodec frontend is a stub: inputs arrive as
precomputed frame embeddings (``batch["embeds"]``); backbone uses
plain-GELU MLPs (non-gated, 4x) and MHA (kv == heads)."""
from repro_torch.configs.base import ModelConfig, tiny_variant

CONFIG = ModelConfig(
    name="musicgen_medium", n_layers=48, d_model=1536, n_heads=24,
    n_kv_heads=24, d_ff=6144, vocab_size=2048, modality="audio",
    gated_mlp=False,
)
SMOKE = tiny_variant(CONFIG)
