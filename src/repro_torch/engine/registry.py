"""Kernel registry: named variants + capability predicates (twin of
``repro.engine.registry``).

Families map to execution substrates, each the twin of a reference family:

  ``cuda``       the hand-written Hopper kernels (reference ``pallas``);
  ``torch``      dequantize + ``torch.matmul`` (reference ``xla``), the
                 fallback for anything the kernels cannot express;
  ``reference``  the plain oracle (tests, debugging).

Variant names keep the reference's with the family swapped
(``pallas:onehot`` <-> ``cuda:onehot``, ``xla:dequant`` <-> ``torch:dequant``,
``ref:jnp`` <-> ``ref:torch``), so a port plan's ``variant_distribution``
compares 1:1 with the reference's.

``backend`` strings: ``"auto"`` (or None) resolves by the *device* of the
plan and tensors, never by ``torch.cuda.is_available()``: CUDA tensors get
``cuda``, CPU tensors ``torch`` (the reference's off-TPU choice).  ``"cuda"``,
``"torch"`` and ``"reference"`` pin their family.  The reference's
``"interpret"`` has no twin -- a CUDA kernel has no interpret mode, and the
CPU path of every kernel wrapper is its plain PyTorch version -- so it, like
any unknown string, raises ``ValueError``.

Mesh context partitions selection as in the reference: a non-empty
``LeafInfo.fsdp`` restricts it to ``sharded=True`` variants (the
``sharded:*`` family, :mod:`repro_torch.engine.sharded`), which own their
collectives; an empty one excludes them.  A mesh-aware plan records each
leaf's distributed layout as a :class:`ShardSpec` in ``ExecSpec.shard``.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Callable, NamedTuple, Optional

import torch

from repro_torch.core.policy import StruMConfig

__all__ = ["LeafInfo", "KernelVariant", "ExecSpec", "ShardSpec", "BACKENDS",
           "FAMILIES",
           "register_kernel", "unregister_kernel", "get_variant",
           "list_variants", "select_variant", "resolve_backend"]

BACKENDS = ("auto", "cuda", "torch", "reference")
FAMILIES = ("cuda", "torch", "reference")


class LeafInfo(NamedTuple):
    """Static shape facts a capability predicate may condition on."""

    k_dim: int
    n_out: int
    lead: tuple = ()
    name: str = ""
    fsdp: tuple = ()      # mesh axes the reduction / block dim is FSDP-sharded
                          # over; non-empty selects the ``sharded:*`` family
    tp_pattern: Optional[str] = None  # 'col' | 'row' TP layout (2-D leaves)
    cache: bool = False   # True selects from the ``cache:*`` family (paged
                          # KV-page codecs: k_dim is the page size, n_out the
                          # per-token feature dim)
    attn: bool = False    # True selects the fused-attention partition of the
                          # cache family (``cache:attn_*``): consumers of the
                          # page pools, not bare codecs
    draft: str = ""       # non-empty selects from the ``draft:*`` partition:
                          # reduced-fidelity lowerings over the same payload
                          # ("histream" | "maskfree_p"), the draft lane
    head_dim: int = 0     # ``cache:attn_*``: the query's per-head width
                          # (0 = not known: a consumer's limit is checked
                          # when it is called)


@dataclasses.dataclass(frozen=True)
class KernelVariant:
    """One registered lowering: ``fn(x2, packed, *, out_dtype) -> y2`` on
    flattened ``(M, K)`` activations and a :class:`PackedStruM`.

    ``grouped=True`` marks a variant that contracts *stacked* leaves: its
    ``fn`` takes ``(lead..., M, K)`` activations and a PackedStruM whose
    fields carry the same lead dims, and returns ``(lead..., M, N)``; its
    ``supports`` requires ``info.lead``, so grouped and 2-D variants never
    compete for a leaf.

    ``cache=True`` marks a KV-page codec (``fn(leaf, *, cfg, page_size,
    out_dtype) -> pages``); ``attn=True`` (implies ``cache``) a consumer of
    the page pools that returns the sealed-page partial of paged attention
    (``repro_torch.engine.cache``).  Selection partitions on both flags, so
    matmul lowerings, page codecs and attention consumers never compete.
    ``draft=True`` marks a reduced-fidelity lowering (``draft:*``) with the
    2-D ``fn`` contract that streams a strict subset of the payload's
    fields; selection considers it only when ``info.draft`` names a mode,
    and its ``supports`` matches that mode, so full-fidelity and draft
    lowerings never compete and neither do the two modes.
    ``sharded=True`` marks a distributed variant (``sharded:*``): its
    ``fn(wleaf, x, *, cfg, mesh, fsdp, pattern, k_dim, backend, out_dtype)``
    takes the payload dict of this rank's shard and the global activations,
    and owns its collectives; selection considers it only when
    ``info.fsdp`` is non-empty.
    ``redispatch=True`` marks a variant whose landing under another family
    is no datapath substitution (it re-selects with the caller's backend
    inside), so the cross-family fallback onto it does not warn.
    ``accum=True`` marks a plain route whose ``fn`` also takes
    ``accum_dtype``, the dtype its f32 product is rounded to before
    ``out_dtype`` (the reference's ``preferred_element_type``).  The CUDA
    kernels and the oracle take none and accumulate in f32, as the
    reference's Pallas variants ignore the argument.
    """

    name: str
    fn: Callable
    supports: Callable[[StruMConfig, LeafInfo], bool]
    family: str = "cuda"
    priority: int = 0
    description: str = ""
    grouped: bool = False
    sharded: bool = False
    redispatch: bool = False
    cache: bool = False
    attn: bool = False
    draft: bool = False
    accum: bool = False


@dataclasses.dataclass(frozen=True)
class ShardSpec:
    """Per-leaf distributed layout recorded by a mesh-aware plan: axis names
    as in the reference, plus the mesh shape the plan was built on.  The
    port's leaf holds this rank's shard of the payload, so it serves only on
    a mesh of that shape (``mesh_shape``, ``((name, size), ...)``); a shape
    of all ones holds the whole payload and also serves without a mesh."""

    fsdp_axes: tuple = ()             # mesh axes the reduction (2-D) or
                                      # packed-block (stacks) dim shards over
    tp_pattern: Optional[str] = None  # 'col' (K FSDP / N TP) or 'row'
                                      # (K TP / N FSDP) for 2-D leaves
    lead_axis: Optional[str] = None   # mesh axis an expert stack's lead dim
                                      # shards over (EP == TP axis)
    mesh_shape: tuple = ()            # ((axis name, size), ...) at build time

    @property
    def parts(self) -> int:
        """How many blocks the packed fields were cut into: the sizes of the
        FSDP axes times the expert axis (stacks) or ``model`` (2-D)."""
        from repro_torch.engine.sharded import field_parts
        return field_parts(self)["mask"]


@dataclasses.dataclass(frozen=True)
class ExecSpec:
    """Per-leaf execution metadata a plan embeds in each packed leaf."""

    cfg: StruMConfig
    variant: str
    backend: Optional[str] = None   # plan-level backend at selection time
    k_dim: Optional[int] = None     # true (unpadded) reduction dim
    shard: Optional[ShardSpec] = None  # distributed layout (mesh-aware plans)


_REGISTRY: dict[str, KernelVariant] = {}


def register_kernel(name: str, *, supports: Callable, family: str = "cuda",
                    priority: int = 0, description: str = "",
                    grouped: bool = False, sharded: bool = False,
                    redispatch: bool = False, cache: bool = False,
                    attn: bool = False, draft: bool = False, accum: bool = False):
    """Decorator: register ``fn`` as kernel variant ``name`` (latest wins)."""
    if family not in FAMILIES:
        raise ValueError(f"unknown family {family!r}")
    if attn and not cache:
        raise ValueError("attn=True variants live in the cache family; "
                         "pass cache=True as well")

    def deco(fn):
        _REGISTRY[name] = KernelVariant(
            name=name, fn=fn, supports=supports, family=family,
            priority=priority, description=description, grouped=grouped,
            sharded=sharded, redispatch=redispatch, cache=cache, attn=attn,
            draft=draft, accum=accum)
        return fn
    return deco


def unregister_kernel(name: str) -> None:
    _REGISTRY.pop(name, None)


def get_variant(name: str) -> KernelVariant:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"no kernel variant {name!r}; registered: "
                       f"{sorted(_REGISTRY)}") from None


def list_variants() -> dict[str, KernelVariant]:
    return dict(_REGISTRY)


def resolve_backend(backend: Optional[str], device=None) -> str:
    """``backend`` string -> family; ``auto`` by the device of the tensors."""
    backend = backend or "auto"
    if backend == "auto":
        if device is None:
            raise ValueError("backend='auto' resolves by the tensors' device; "
                             "pass device=")
        return "cuda" if torch.device(device).type == "cuda" else "torch"
    if backend in FAMILIES:
        return backend
    hint = " (a CUDA kernel has no interpret mode; on CPU tensors the " \
           "kernel wrappers run their plain PyTorch versions)" \
        if backend == "interpret" else ""
    raise ValueError(f"unknown backend {backend!r}; want one of {BACKENDS}{hint}")


def select_variant(cfg: StruMConfig, info: LeafInfo,
                   backend: Optional[str] = None, device=None) -> KernelVariant:
    """Highest-(priority, name) variant of the resolved family whose
    predicate accepts ``(cfg, info)``; if that family has none (e.g.
    ``w % 8 != 0`` under onehot), fall back to the ``torch`` family, with a
    warning when the family was asked for explicitly (unless the fallback
    is a ``redispatch`` variant).  ``info.fsdp``, ``info.cache``,
    ``info.attn`` and ``info.draft`` partition the candidates: only variants
    with the same four flags compete, and the fallback stays inside the
    partition."""
    fam = resolve_backend(backend, device)
    for family in dict.fromkeys((fam, "torch")):
        cands = [v for v in _REGISTRY.values()
                 if v.family == family and v.sharded == bool(info.fsdp)
                 and v.cache == info.cache
                 and v.attn == info.attn and v.draft == bool(info.draft)
                 and v.supports(cfg, info)]
        if cands:
            best = max(cands, key=lambda v: (v.priority, v.name))
            if family != fam and backend not in (None, "auto") \
                    and not best.redispatch:
                warnings.warn(
                    f"backend={backend!r} has no variant supporting "
                    f"{cfg.method} w={cfg.w} n_low={cfg.n_low} "
                    f"({info.name or 'leaf'}); falling back to {family!r}",
                    stacklevel=2)
            return best
    raise LookupError(f"no registered kernel variant supports cfg={cfg} "
                      f"info={info} backend={backend!r}")
