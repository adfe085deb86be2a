"""Checkpoints (twin of ``repro.checkpoint``)."""
from repro_torch.checkpoint import checkpoint

__all__ = ["checkpoint"]
