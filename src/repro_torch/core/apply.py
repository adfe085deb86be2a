"""StruM over single tensors and whole parameter trees (twin of
``repro.core.apply``).

Per array: ``fake_quantize_array``, ``pack_array``, ``unpack_array``,
``int8_baseline_array``.  Blocks run along axis ``-2`` of every kernel
(``(..., in, out)``); leading dims fold into the output-channel dim, each
column keeping its own int8 scale.

Per tree: ``path_name`` and ``_named_leaves`` name every leaf as the
reference's ``jax.tree_util`` walk does, in its order;
``tree_compression_report`` prices a tree under a policy or schedule;
``fake_quantize_tree`` and ``pack_tree`` are deprecated shims over
:func:`repro_torch.engine.build_plan` (``scope="tree"``), as in the
reference.
"""
from __future__ import annotations

import warnings
from typing import Any, Callable, Optional

import torch

from repro_torch.core import blocking, packing
from repro_torch.core.policy import LayerPolicy, StruMConfig, default_policy
from repro_torch.core.quantizers import int8_symmetric, quantize_blocks

__all__ = ["fake_quantize_array", "pack_array", "unpack_array",
           "int8_baseline_array", "packed_payload_bytes", "path_name",
           "map_named", "tree_leaves", "tree_like", "fake_quantize_tree",
           "pack_tree", "tree_compression_report"]


def _to_2d(x: torch.Tensor):
    """(..., K, N) -> (K, prod(lead)*N) with per-column identity preserved."""
    k = x.shape[-2]
    return torch.movedim(x, -2, 0).reshape(k, -1), tuple(x.shape)


def _from_2d(x2: torch.Tensor, shape: tuple) -> torch.Tensor:
    k = shape[-2]
    lead = shape[:-2] + (shape[-1],)
    return torch.movedim(x2.reshape((k,) + lead), 0, -2)


def _quantize_2d(x2: torch.Tensor, cfg: StruMConfig):
    codes, scale = int8_symmetric(x2, axis=0)
    blocks = blocking.to_blocks(codes, cfg.w)
    return quantize_blocks(blocks, cfg.method, cfg.n_low, q=cfg.q, L=cfg.L), scale


def fake_quantize_array(x: torch.Tensor, cfg: StruMConfig) -> torch.Tensor:
    """INT8 calibrate -> block -> set-quantize -> dequantize; same shape."""
    x2, shape = _to_2d(x)
    qb, scale = _quantize_2d(x2, cfg)
    vals = blocking.from_blocks(qb.values, x2.shape[0])
    return _from_2d((vals.to(torch.float32) * scale).to(x.dtype), shape)


def pack_array(x: torch.Tensor, cfg: StruMConfig) -> packing.PackedStruM:
    """Compress one weight tensor to the Fig.-5 encoded form."""
    x2, _ = _to_2d(x)
    qb, scale = _quantize_2d(x2, cfg)
    return packing.pack(qb, method=cfg.method, scale=scale, k_dim=x2.shape[0],
                        n_low=cfg.n_low, q=cfg.q, L=cfg.L)


def unpack_array(p: packing.PackedStruM, shape: tuple,
                 dtype=torch.float32) -> torch.Tensor:
    """Decompress a packed tensor back to its original shape."""
    return _from_2d(packing.dequantize(p, dtype), tuple(shape))


def packed_payload_bytes(shape: tuple, cfg: StruMConfig) -> int:
    """Realized packed bytes (mask + hi + lo) for a tensor of ``shape``."""
    k = shape[-2]
    n = 1
    for d in tuple(shape[:-2]) + tuple(shape[-1:]):
        n *= d
    mb, nh, lb = packing.field_dims(cfg.w, cfg.n_low, cfg.q, cfg.method)
    return blocking.num_blocks(k, cfg.w) * (mb + nh + lb) * n


# ------------------------------------------------------------ tree half --
#
# ``jax.tree_util`` is the reference's tree walker; these helpers give the
# same leaves under the same names in the same order: dict children in
# sorted key order, list and tuple children by index, namedtuple children
# as ``.field``, ``None`` dropped (an empty subtree), anything else a leaf.

def path_name(path) -> str:
    """Canonical ``/``-joined name of a key path: the one naming convention
    plan entries, pack manifests and schedules are keyed by."""
    return "/".join(str(k) for k in path)


def _children(node):
    """(key, child) pairs of a container in the reference's order, or None
    for a leaf."""
    if isinstance(node, dict):
        return [(k, node[k]) for k in sorted(node)]
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return [(f".{f}", getattr(node, f)) for f in node._fields]
    if isinstance(node, (list, tuple)):
        return list(enumerate(node))
    return None


def _flatten_with_path(tree, path=()):
    if tree is None:
        return
    kids = _children(tree)
    if kids is None:
        yield path, tree
        return
    for k, v in kids:
        yield from _flatten_with_path(v, path + (k,))


def _named_leaves(tree: Any):
    """(name, leaf) of every leaf of ``tree``, in ``jax.tree_util`` order."""
    for path, leaf in _flatten_with_path(tree):
        yield path_name(path), leaf


def tree_leaves(tree: Any) -> list:
    """Every leaf of ``tree``, in ``_named_leaves`` order."""
    return [leaf for _, leaf in _named_leaves(tree)]


def tree_like(tree: Any, leaves) -> Any:
    """``tree``'s structure holding ``leaves`` (in ``_named_leaves`` order)."""
    it = iter(leaves)
    return map_named(lambda _, __: next(it), tree)


def map_named(fn: Callable, tree: Any, is_leaf: Optional[Callable] = None,
              path: tuple = ()) -> Any:
    """``fn(name, leaf)`` over every leaf, visited in ``_named_leaves``
    order; containers keep their own type and key order, ``None`` stays.
    ``is_leaf(node)`` marks subtrees handed to ``fn`` whole."""
    if tree is None:
        return None
    if is_leaf is not None and is_leaf(tree):
        return fn(path_name(path), tree)
    kids = _children(tree)
    if kids is None:
        return fn(path_name(path), tree)
    done = {k: map_named(fn, v, is_leaf, path + (k,)) for k, v in kids}
    if isinstance(tree, dict):
        return {k: done[k] for k in tree}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(done[f".{f}"] for f in tree._fields))
    return type(tree)(done[i] for i in range(len(tree)))


def int8_baseline_array(x: torch.Tensor) -> torch.Tensor:
    """The paper's baseline: plain symmetric INT8 round-trip."""
    x2, shape = _to_2d(x)
    codes, scale = int8_symmetric(x2, axis=0)
    return _from_2d((codes.to(torch.float32) * scale).to(x.dtype), shape)


def _policy_from(policy: Optional[LayerPolicy], schedule: Any) -> LayerPolicy:
    """An explicit schedule wins, then the explicit policy, then the repo
    default.  ``schedule`` is anything with a ``to_policy()``."""
    if schedule is not None:
        return schedule.to_policy()
    return policy or default_policy()


def fake_quantize_tree(params: Any, policy: Optional[LayerPolicy] = None,
                       baseline_int8: bool = True, *, schedule: Any = None,
                       device="cuda") -> Any:
    """Deprecated shim over :func:`repro_torch.engine.fake_quantize`: a
    selection-only plan, then the StruM round-trip of every planned leaf
    (the plain INT8 round-trip of other float matrices when
    ``baseline_int8``).  ``schedule`` takes precedence over ``policy``."""
    warnings.warn(
        "fake_quantize_tree is deprecated; use repro_torch.engine.fake_quantize",
        DeprecationWarning, stacklevel=2)
    from repro_torch.engine import fake_quantize
    return fake_quantize(params, schedule=schedule,
                         policy=policy if schedule is None else None,
                         baseline_int8=baseline_int8, device=device)


def pack_tree(params: Any, policy: Optional[LayerPolicy] = None, *,
              schedule: Any = None, device="cuda") -> dict:
    """Deprecated shim over :func:`repro_torch.engine.build_plan` with
    ``scope="tree"``: the flat manifest ``{name: (PackedStruM, shape)}`` for
    eligible leaves, ``{name: leaf}`` otherwise.  ``schedule`` (e.g. loaded
    from disk) takes precedence over ``policy``."""
    warnings.warn(
        "pack_tree is deprecated; use repro_torch.engine.build_plan(..., "
        "scope='tree').params", DeprecationWarning, stacklevel=2)
    from repro_torch.engine import build_plan
    return build_plan(params, schedule=schedule,
                      policy=policy if schedule is None else None,
                      scope="tree", device=device).params


def tree_compression_report(params: Any, policy: Optional[LayerPolicy] = None,
                            *, schedule: Any = None) -> dict:
    """Bytes before and after per tensor and in total: the theoretical
    Eq.-1/2 bytes (``strum_bytes``) beside the realized packed bytes
    (``packed_bytes``, the PackedStruM field sizes with block and bit-field
    padding).  Shapes only: nothing is packed or moved."""
    policy = _policy_from(policy, schedule)
    rows, tot_in, tot_out, tot_packed = [], 0, 0, 0
    for name, leaf in _named_leaves(params):
        if not isinstance(leaf, torch.Tensor):
            continue
        shape = tuple(leaf.shape)
        int8_bytes = leaf.numel()          # vs the INT8 baseline, as in the paper
        cfg = policy.resolve(name, shape)
        if cfg is None:
            comp = packed = int8_bytes
            ratio = 1.0
        else:
            comp = int(round(int8_bytes * cfg.compression_ratio))
            ratio = cfg.compression_ratio
            packed = packed_payload_bytes(shape, cfg)
        rows.append({"name": name, "int8_bytes": int8_bytes,
                     "strum_bytes": comp, "ratio": ratio,
                     "packed_bytes": packed,
                     "packed_ratio": packed / max(int8_bytes, 1)})
        tot_in += int8_bytes
        tot_out += comp
        tot_packed += packed
    return {"tensors": rows, "total_int8_bytes": tot_in,
            "total_strum_bytes": tot_out,
            "total_ratio": tot_out / max(tot_in, 1),
            "total_packed_bytes": tot_packed,
            "total_packed_ratio": tot_packed / max(tot_in, 1)}
