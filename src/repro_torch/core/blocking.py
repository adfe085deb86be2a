"""Hardware-aware block division (paper §IV-B), PyTorch twin of
``repro.core.blocking``.

Weights ``(K, N)`` are cut along the reduction dim ``K`` into ``[1, w]``
blocks; the last block is zero-padded.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["pad_to_block", "unpad_from_block", "to_blocks", "from_blocks",
           "num_blocks", "block_shape_ok", "np_to_blocks"]


def num_blocks(k: int, w: int) -> int:
    """Number of ``[1, w]`` blocks covering a reduction dim of size ``k``."""
    return -(-k // w)


def pad_to_block(x: torch.Tensor, w: int) -> torch.Tensor:
    """Zero-pad the reduction (first) dim of ``(K, N)`` to a multiple of ``w``."""
    k = x.shape[0]
    pad = num_blocks(k, w) * w - k
    if pad == 0:
        return x
    return torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))], dim=0)


def unpad_from_block(x: torch.Tensor, k: int) -> torch.Tensor:
    return x[:k]


def to_blocks(x: torch.Tensor, w: int) -> torch.Tensor:
    """``(K, N) -> (nb, w, N)``: one ``[1, w]`` block per (nb, :, n) slice."""
    x = pad_to_block(x, w)
    return x.reshape((x.shape[0] // w, w) + tuple(x.shape[1:]))


def from_blocks(blocks: torch.Tensor, k: int) -> torch.Tensor:
    """``(nb, w, N) -> (K, N)``, inverse of :func:`to_blocks`."""
    nb, w = blocks.shape[:2]
    return unpad_from_block(blocks.reshape((nb * w,) + tuple(blocks.shape[2:])), k)


def block_shape_ok(w: int) -> bool:
    """The reference's guard, kept as it is: w divides 128, the TPU's tile
    alignment.  The CUDA kernels state their own limits in their launchers'
    ``launch_contract``."""
    return w > 0 and 128 % w == 0


def np_to_blocks(x: np.ndarray, w: int) -> np.ndarray:
    """NumPy twin of :func:`to_blocks` for offline encoders."""
    k = x.shape[0]
    pad = num_blocks(k, w) * w - k
    if pad:
        x = np.pad(x, [(0, pad)] + [(0, 0)] * (x.ndim - 1))
    return x.reshape((x.shape[0] // w, w) + x.shape[1:])
