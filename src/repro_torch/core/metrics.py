"""Quantization quality metrics (twin of ``repro.core.metrics``), every one
computed in f32 as the reference computes it."""
from __future__ import annotations

import torch

__all__ = ["l2_error", "rel_l2_error", "sqnr_db", "cosine_sim"]


def _f32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float32).reshape(-1)


def l2_error(x: torch.Tensor, xq: torch.Tensor) -> torch.Tensor:
    """The paper's objective: ‖x − x_q‖₂ (per tensor)."""
    return torch.linalg.vector_norm(_f32(x - xq))


def rel_l2_error(x: torch.Tensor, xq: torch.Tensor) -> torch.Tensor:
    denom = torch.clamp(torch.linalg.vector_norm(_f32(x)), min=1e-12)
    return l2_error(x, xq) / denom


def sqnr_db(x: torch.Tensor, xq: torch.Tensor) -> torch.Tensor:
    """Signal-to-quantization-noise ratio in dB (higher = better)."""
    sig = torch.sum(torch.square(x.to(torch.float32)))
    noise = torch.clamp(torch.sum(torch.square((x - xq).to(torch.float32))),
                        min=1e-20)
    return 10.0 * torch.log10(torch.clamp(sig, min=1e-20) / noise)


def cosine_sim(x: torch.Tensor, xq: torch.Tensor) -> torch.Tensor:
    a, b = _f32(x), _f32(xq)
    na = torch.clamp(torch.linalg.vector_norm(a), min=1e-12)
    nb = torch.clamp(torch.linalg.vector_norm(b), min=1e-12)
    return torch.dot(a, b) / (na * nb)
