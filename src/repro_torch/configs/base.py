"""Model configuration, a jax-free copy of ``repro.configs.base`` with the
same ``ModelConfig`` fields and ``tiny_variant`` rule.  Every architecture
of the reference has a module here (``ARCH_IDS``, in the reference's
order); each exports ``CONFIG`` (the published shape) and ``SMOKE``.  ``SHAPES``
holds the reference's four dry-run cells (``launch.dryrun``).
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Optional

import torch

from repro_torch.core.policy import StruMConfig

__all__ = ["ModelConfig", "ShapeSpec", "SHAPES", "ARCH_IDS", "get_config",
           "get_smoke_config", "tiny_variant"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    family: str = "dense"          # dense | moe | ssm | hybrid
    modality: str = "text"         # text | audio | vlm (non-text: stub frontend)
    head_dim: Optional[int] = None  # default d_model // n_heads
    qkv_bias: bool = False
    norm: str = "rms"              # rms | nonparam (OLMo layer norm w/o params)
    gated_mlp: bool = True
    tie_embeddings: bool = False
    rope_theta: float = 1e4
    n_experts: int = 0
    top_k: int = 0
    moe_every: int = 1
    capacity_factor: float = 2.0
    router_aux_weight: float = 0.01
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    attn_every: int = 0
    dtype: str = "bfloat16"        # activation dtype
    remat: bool = True
    remat_policy: str = "full"
    accum_dtype: str = "float32"
    scan_layers: bool = True
    attn_heads_constraint: bool = False
    ssm_split_proj: bool = False
    attn_chunk: int = 1024
    strum: Optional[StruMConfig] = None

    @property
    def hd(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up to 256, as the reference pads it; labels index
        the true vocab and the extra columns are inert."""
        return -(-self.vocab_size // 256) * 256

    @property
    def activation_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for long contexts (SSM / hybrid-with-sparse-attention)."""
        return self.family in ("ssm", "hybrid")

    @property
    def ssm_heads(self) -> int:
        return (self.ssm_expand * self.d_model) // self.ssm_head_dim

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    def layer_kind(self, i: int) -> str:
        """'attn' | 'ssm' for layer i (hybrid: one attention layer per
        period, at its last slot)."""
        if self.family == "ssm":
            return "ssm"
        if self.family == "hybrid" and self.attn_every > 0:
            return "attn" if (i % self.attn_every) == self.attn_every - 1 else "ssm"
        return "attn"

    def layer_is_moe(self, i: int) -> bool:
        return self.n_experts > 0 and (i % max(self.moe_every, 1)) == self.moe_every - 1

    def param_count(self) -> int:
        """Analytic parameter count (embedding + layers)."""
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        hd, nh, nkv = self.hd, self.n_heads, self.n_kv_heads
        total = v * d * (1 if self.tie_embeddings else 2)
        mult = 3 if self.gated_mlp else 2
        for i in range(self.n_layers):
            if self.layer_kind(i) == "attn":
                total += d * (nh * hd) + 2 * d * (nkv * hd) + (nh * hd) * d
            else:
                di, ns, nh_s = self.d_inner, self.ssm_state, self.ssm_heads
                total += d * (2 * di + 2 * ns + nh_s) + di * d
            if self.layer_is_moe(i):
                total += self.n_experts * mult * d * f + d * self.n_experts
            elif f > 0:
                total += mult * d * f
        return total

    def active_param_count(self) -> int:
        """Per-token active params (MoE: top_k of n_experts)."""
        total = self.param_count()
        mult = 3 if self.gated_mlp else 2
        for i in range(self.n_layers):
            if self.layer_is_moe(i):
                total -= (self.n_experts - self.top_k) * mult * self.d_model * self.d_ff
        return total


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}

ARCH_IDS = (
    "jamba_1_5_large_398b",
    "qwen2_7b",
    "olmo_1b",
    "stablelm_12b",
    "deepseek_67b",
    "musicgen_medium",
    "internvl2_26b",
    "qwen3_moe_235b_a22b",
    "moonshot_v1_16b_a3b",
    "mamba2_780m",
)


def get_config(arch: str) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{arch.replace('-', '_')}")
    return mod.CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{arch.replace('-', '_')}")
    return mod.SMOKE


def tiny_variant(cfg: ModelConfig, **over) -> ModelConfig:
    """Reduced same-family config for CPU smoke tests."""
    period = cfg.attn_every if cfg.family == "hybrid" else 0
    fields = dict(
        n_layers=4 if cfg.family == "hybrid" else 2,
        d_model=64,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 4) if cfg.n_kv_heads else 4,
        head_dim=16,
        d_ff=128 if cfg.d_ff else 0,
        vocab_size=256,
        n_experts=min(cfg.n_experts, 4),
        top_k=min(cfg.top_k, 2),
        ssm_state=min(cfg.ssm_state, 16) if cfg.ssm_state else 0,
        ssm_head_dim=16,
        attn_every=2 if period else 0,
        attn_chunk=32,
        capacity_factor=4.0,
        name=cfg.name + "_smoke",
    )
    fields.update(over)
    return dataclasses.replace(cfg, **fields)
