"""One-shot, data-free per-tensor sensitivity profiling (twin of
``repro.autotune.sensitivity``).

For every eligible tensor the profiler measures the SQNR of each candidate
``StruMConfig`` in a grid: the quantity the paper's encoder minimizes
(‖x − x_q‖₂, §IV-C) and the proxy the schedule search trades against the
hardware cost model.  It needs no data: it is a function of the weights.

Batching: candidates that share ``(method, w, q, L)`` differ only in ``p``,
i.e. in how many elements per block land in the low set.  The block
ranking and the low-set replacement values are computed once per group,
and one broadcast pass over the stacked ``n_low`` values scores every
``p`` of the group on the tensor's own device (the reference's
``jax.vmap`` over ``n_low``).

Caching: results are memoized by (tensor content hash, grid signature), so
repeated searches over the same weights (budget sweeps) profile nothing
twice.  The key is the tensor's bytes, never its address: a freed
allocation that is reused must not hit a stale entry.  Hashing a tensor on
the card copies it to the host first.

``output_error_profile`` composes the SQNR with each leaf's output noise
gain from the static numerics pass (``analysis.numerics.output_gains``).
"""
from __future__ import annotations

import hashlib
from typing import Optional, Sequence

import torch

from repro_torch.autotune.schedule import config_key
from repro_torch.core import blocking
from repro_torch.core.apply import _from_2d, _named_leaves, _to_2d
from repro_torch.core.policy import LayerPolicy, StruMConfig, default_policy
from repro_torch.core.quantizers import int8_symmetric, pow2_round, rank_in_block

__all__ = ["DEFAULT_GRID", "profile_array", "int8_sqnr_db", "profile_tree",
           "output_error_profile", "clear_cache", "cache_info"]

#: candidate grid used when callers don't supply one: the paper's three
#: methods over its p grid, with both MIP2Q shifter ranges (Fig. 11/12).
DEFAULT_GRID = tuple(
    [StruMConfig(method="sparsity", p=p) for p in (0.25, 0.5, 0.75)]
    + [StruMConfig(method="dliq", p=p, q=4) for p in (0.25, 0.5, 0.75)]
    + [StruMConfig(method="mip2q", p=p, L=L)
       for p in (0.25, 0.5, 0.75) for L in (5, 7)]
)

_CACHE: dict = {}
_CACHE_STATS = {"hits": 0, "misses": 0}


def clear_cache() -> None:
    _CACHE.clear()
    _CACHE_STATS.update(hits=0, misses=0)


def cache_info() -> dict:
    return dict(_CACHE_STATS, entries=len(_CACHE))


def _tensor_digest(x: torch.Tensor) -> str:
    """SHA-1 of the tensor's bytes (copied to the host), shape and dtype."""
    a = x.detach().contiguous().reshape(-1).view(torch.uint8).cpu().numpy()
    h = hashlib.sha1(a.tobytes())
    h.update(str((tuple(x.shape), str(x.dtype))).encode())
    return h.hexdigest()


def _low_replacement(blocks: torch.Tensor, cfg: StruMConfig):
    """(rank key, replacement values) for one (method, q, L) group.

    The key orders elements by demotion preference (the encoders' order in
    :mod:`repro_torch.core.quantizers`, bit for bit); the replacement value
    is what a demoted element becomes on the int8 grid.
    """
    c = blocks.to(torch.int32)
    if cfg.method == "sparsity":
        return c.abs(), torch.zeros_like(c)
    if cfg.method == "dliq":
        step = 1 << (8 - cfg.q)
        qmax = (1 << (cfg.q - 1)) - 1
        mant = torch.clamp(torch.round(c.to(torch.float32) / step),
                           -qmax, qmax).to(torch.int32)
        return c.abs(), mant * step
    # mip2q: the exact L2-optimal low set, smallest pow2-rounding error
    # first, ties by |magnitude| (pow2_error_low_mask's combined key)
    p2 = pow2_round(blocks, cfg.L)
    return (c - p2).abs() * 256 + c.abs(), p2


def profile_array(x: torch.Tensor, grid: Sequence[StruMConfig] = DEFAULT_GRID,
                  use_cache: bool = True) -> dict:
    """{config_key: SQNR dB} of ``x`` under every grid candidate.

    Candidates sharing (method, w, q, L) are scored in one broadcast pass
    over their ``n_low`` values.  Matches ``sqnr_db(x,
    fake_quantize_array(x, cfg))`` (same encode path, same round trip
    through ``x.dtype``) up to the order of the f32 sums.
    """
    grid = tuple(grid)
    key = (_tensor_digest(x), tuple(config_key(c) for c in grid)) \
        if use_cache else None
    if key is not None and key in _CACHE:
        _CACHE_STATS["hits"] += 1
        return dict(_CACHE[key])
    _CACHE_STATS["misses"] += 1

    # noise sums run over the (K, cols) view: the same elements as x's
    x2, _ = _to_2d(x)
    codes, scale = int8_symmetric(x2, axis=0)
    k = x2.shape[0]
    x2f = x2.to(torch.float32)
    sig = torch.clamp(torch.sum(torch.square(x.to(torch.float32))), min=1e-20)

    groups: dict = {}
    for cfg in grid:
        groups.setdefault((cfg.method, cfg.w, cfg.q, cfg.L), []).append(cfg)

    out: dict = {}
    for (_method, w, _q, _L), cfgs in groups.items():
        blocks = blocking.to_blocks(codes, w)
        rank_key, repl = _low_replacement(blocks, cfgs[0])
        rank = rank_in_block(rank_key)
        c = blocks.to(torch.int32)
        del rank_key
        n_lows = torch.tensor([cfg.n_low for cfg in cfgs], dtype=rank.dtype,
                              device=rank.device).view(-1, 1, 1, 1)
        vals = torch.where(rank.unsqueeze(0) < n_lows, repl, c)   # (G, nb, w, N)
        del rank, repl, c
        v2 = vals.reshape(len(cfgs), -1, vals.shape[-1])[:, :k]
        # the reference's round trip: dequantize in f32, cast to x's dtype
        deq = (v2.to(torch.float32) * scale).to(x.dtype).to(torch.float32)
        del vals, v2
        noise = torch.clamp(deq.sub_(x2f).square_().sum(dim=(1, 2)), min=1e-20)
        sqnrs = (10.0 * torch.log10(sig / noise)).tolist()
        del deq
        for cfg, s in zip(cfgs, sqnrs):
            out[config_key(cfg)] = float(s)

    if key is not None:
        _CACHE[key] = dict(out)
    return out


def int8_sqnr_db(x: torch.Tensor) -> float:
    """SQNR of the plain-INT8 round trip: the ``None`` candidate's score."""
    x2, shape = _to_2d(x)
    codes, scale = int8_symmetric(x2, axis=0)
    deq = _from_2d((codes.to(torch.float32) * scale).to(x.dtype), shape)
    xf = x.to(torch.float32)
    sig = torch.clamp(torch.sum(torch.square(xf)), min=1e-20)
    noise = torch.clamp(torch.sum(torch.square(xf - deq.to(torch.float32))),
                        min=1e-20)
    return float(10.0 * torch.log10(sig / noise))


def profile_tree(params, grid: Sequence[StruMConfig] = DEFAULT_GRID,
                 base_policy: Optional[LayerPolicy] = None,
                 use_cache: bool = True) -> dict:
    """Profile every eligible tensor of a parameter tree, on its device.

    Returns {name: {"size": int, "ms": float, "int8_sqnr_db": float,
    "sqnr_db": {config_key: float}}} for the tensors ``base_policy`` deems
    eligible (its resolve() is the test: excluded and 1-D tensors are
    skipped, as the packers skip them), in the reference's name order.
    ``ms`` is the tensor's mean square, a float64 mean on its device.
    """
    base_policy = base_policy or default_policy()
    out = {}
    for name, leaf in _named_leaves(params):
        if not isinstance(leaf, torch.Tensor):
            continue
        if base_policy.resolve(name, tuple(leaf.shape)) is None:
            continue
        out[name] = {
            "size": int(leaf.numel()),
            "ms": float(torch.mean(torch.square(leaf.to(torch.float64)))),
            "int8_sqnr_db": int8_sqnr_db(leaf),
            "sqnr_db": profile_array(leaf, grid, use_cache=use_cache),
        }
    return out


def output_error_profile(params, fn, *fn_args,
                         grid: Sequence[StruMConfig] = DEFAULT_GRID,
                         base_policy: Optional[LayerPolicy] = None,
                         profile: Optional[dict] = None,
                         use_cache: bool = True, **fn_kwargs) -> dict:
    """Activation-aware sensitivity: weight SQNR composed with the model's
    statically derived per-leaf noise gains.

    One :func:`repro_torch.analysis.numerics.output_gains` pass over one
    recorded run of ``fn(params, *fn_args)`` seeds a unit mean-square
    perturbation at every eligible leaf and reads off the *output* error
    power it induces — each leaf's gain ``G``.  A candidate config's
    predicted output error power is then ``G · ms(W) · 10^(−SQNR/10)``
    (leaf noise power rescaled by how much of it survives to the logits),
    which is what separates an attention projection from an equally-SQNR'd
    MLP matrix.

    Returns :func:`profile_tree` rows extended with ``"gain"`` and
    ``"output_err2": {config_key: predicted output error power}``; feed it
    to ``search_schedule(..., proxy="output_error")``.
    """
    from repro_torch.analysis import numerics

    base_policy = base_policy or default_policy()
    if profile is None:
        profile = profile_tree(params, grid, base_policy=base_policy,
                               use_cache=use_cache)
    gains = numerics.output_gains(fn, params, *fn_args,
                                  names=tuple(sorted(profile)),
                                  location="autotune.output_error_profile",
                                  **fn_kwargs)
    out = {}
    for name, row in profile.items():
        g = float(gains.get(name, 0.0))
        row = dict(row, gain=g)
        row["output_err2"] = {
            key: g * row["ms"] * 10.0 ** (-s / 10.0)
            for key, s in row["sqnr_db"].items()}
        row["int8_output_err2"] = (
            g * row["ms"] * 10.0 ** (-row["int8_sqnr_db"] / 10.0))
        out[name] = row
    return out
