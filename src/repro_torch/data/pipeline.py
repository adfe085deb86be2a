"""Deterministic synthetic token pipeline, sharded per host (twin of
``repro.data.pipeline``).

A stateless mapping ``(seed, step, row) -> tokens``: any host computes any
shard of any step from those alone, so a restart replays step N's batch
exactly and there is no iterator state to checkpoint.  The stream is a
Zipf unigram base with a deterministic k-gram overlay, so a model can
learn it.  Tokens are drawn with numpy exactly as the reference draws
them (the same ``SeedSequence``, Zipf draw and overlay), then handed to
torch on ``device``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import resolve_device

__all__ = ["DataConfig", "global_batch", "host_shard", "batch_specs"]


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 1234
    zipf_a: float = 1.2
    structure: int = 3   # k-gram order of the learnable structure


def _token_block(cfg: DataConfig, step: int, row: int) -> np.ndarray:
    """One (seq_len+1,) int32 row, deterministic in (seed, step, row)."""
    rng = np.random.default_rng(np.random.SeedSequence([cfg.seed, step, row]))
    v = cfg.vocab_size
    base = (rng.zipf(cfg.zipf_a, size=cfg.seq_len + 1) - 1) % v
    # overlay deterministic k-gram structure: x[t] = f(x[t-k]) on half the steps
    k = cfg.structure
    mix = rng.random(cfg.seq_len + 1) < 0.5
    out = base.copy()
    for t in range(k, cfg.seq_len + 1):
        if mix[t]:
            out[t] = (out[t - k] * 31 + 7) % v
    return out.astype(np.int32)


def _batch(rows: np.ndarray, device) -> dict:
    t = torch.from_numpy(rows).to(resolve_device(device), torch.long)
    return {"tokens": t[:, :-1], "labels": t[:, 1:]}


def global_batch(cfg: DataConfig, step: int, device="cuda") -> dict:
    """Full global batch for ``step``: ``tokens`` and ``labels`` (B, S)
    int64 on ``device``."""
    return _batch(np.stack([_token_block(cfg, step, r)
                            for r in range(cfg.global_batch)]), device)


def host_shard(cfg: DataConfig, step: int, host_id: int, n_hosts: int,
               device="cuda") -> dict:
    """This host's contiguous row range of the global batch."""
    per = cfg.global_batch // n_hosts
    return _batch(np.stack([_token_block(cfg, step, host_id * per + r)
                            for r in range(per)]), device)


def batch_specs(cfg: DataConfig, d_model: int = 0, modality: str = "text") -> dict:
    """``meta`` stand-ins of a global batch for the dry-run (nothing drawn or
    allocated).  The reference's int32 tokens and labels are int64 here, the
    port's token dtype (:func:`global_batch`); a non-text modality's
    ``embeds`` are bf16 ``(B, S, d_model)``, as in the reference."""
    b, s = cfg.global_batch, cfg.seq_len
    out = {"labels": torch.empty((b, s), dtype=torch.long, device="meta")}
    if modality == "text":
        out["tokens"] = torch.empty((b, s), dtype=torch.long, device="meta")
    else:   # stub frontend: precomputed frame / patch embeddings
        out["embeds"] = torch.empty((b, s, d_model), dtype=torch.bfloat16,
                                    device="meta")
    return out
