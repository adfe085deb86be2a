"""Logical-axis sharding rules and the collectives of a device mesh (twin of
``repro.models.sharding``).

Every parameter is declared with *logical* axis names (``ParamDef.axes``);
rules map them to mesh axes, as in the reference:

  * the ``embed``-like (reduction / d_model) dim of every weight shards over
    the data axis: ZeRO-3 / FSDP storage, gathered per use,
  * output-feature dims (heads, mlp, vocab, experts) shard over ``model``,
  * stacked-layer dims never shard.

The port runs one process per rank (``torch.distributed``) over a
``DeviceMesh``.  Four layouts share these helpers:

* **the sharded serving layout** (the reference's ``input_shardings``):
  the ``prefill`` and ``decode_step`` of every family on a mesh take every
  input at its spec and each rank holds and computes its block.  Weights
  are this rank's shards (:func:`repro_torch.models.params.shard_params`),
  activations split their batch over the data axes, the attention caches
  also their sequence over ``model`` and the SSM caches their channels and
  heads.  The collectives GSPMD places in the reference are written out
  where the layout needs them (the FSDP gather of a weight per use, the
  row-parallel all-reduce, the vocab-parallel embedding, the flash-decode
  merge, the expert-parallel combine, the SSM mixer's gathers of its
  projections and conv output).  A tensor placed so carries a
  :class:`Placement` (global shape and spec), and :func:`constrain` moves a
  tensor to the block its logical axes name, by slicing a whole tensor or
  by collectives from another placement;
* **the paged layout** of the serving runtime's lanes (the decode lane,
  the chunked and serial prefill, the verify lane) on a mesh, as the
  reference's scheduler runs them: dense weights whole (a placed one
  raises), packed weights a mesh-aware plan's block through the
  ``sharded:*`` family, the lane's batch over the data axes where they
  divide it and whole on every rank where they do not
  (:func:`lane_rules`), page pools and per-slot tails whole and equal on
  every rank.  :func:`constrain` cuts the activations to this rank's rows;
  what a lane writes for its rows is all-gathered after it
  (``models.transformer``);
* **the replicated layout**, kept by the ZeRO-3 step
  (``launch.steps._zero3_step``, a yardstick no longer selected): dense
  weights, activations and caches global and replicated on every rank,
  packed weights a mesh-aware plan's block, collectives only inside the
  reference's ``shard_map`` bodies (the ``sharded:*`` variants, the MoE
  body, the pipeline ring).  There :func:`check_axes` checks the logical
  axes and moves nothing, and a placed (sharded) dense leaf raises;
* **the train layout** of every family (``launch.steps.make_train_step``
  on a mesh): weights held as the sharded serving layout holds them, each
  rank computing its block of the heads, the MLP, the experts, the SSM
  heads and channels and the vocabulary; its collectives are
  :func:`all_gather`, :func:`all_reduce`, :func:`grad_all_reduce` and
  :func:`shared_all_reduce`, which autograd differentiates.

A mesh is a ``torch.distributed.device_mesh.DeviceMesh``
(:func:`repro_torch.launch.mesh.make_host_mesh`); the helpers here also take
any object with ``axis_names`` and a ``shape`` dict, as the reference's
tests pass, wherever no collective runs.  Collectives use what both gloo and
NCCL implement: ``all_gather`` in its list form and ``all_reduce``, over the
mesh's process groups (``DeviceMesh.get_group``; a flattened sub-mesh where
several axes act as one, such as ``("pod", "data")``).  On an abstract mesh
(:class:`repro_torch.launch.mesh.AbstractMesh`: no process group, one
rank's coordinate) they take ``meta`` tensors only and build the result's
shape alone, so the dry-run counts one rank of a production mesh; any other
tensor there raises.  Under gloo a CUDA tensor's stream is synchronized
before its collective (gloo copies it through the host).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from repro_torch.kernels import hooks

__all__ = [
    "PartitionSpec", "P", "Rules", "TRAIN_RULES", "POD_TRAIN_RULES",
    "rules_for_mesh", "fsdp_axes", "spec_for_axes", "shard_leaf", "constrain",
    "batch_spec", "shard_map", "axis_names", "axis_sizes", "axis_size",
    "axis_index", "all_gather", "gather_out", "all_reduce", "shard_slice",
    "Placement", "place", "placement", "is_sharded", "check_axes",
    "place_tree", "tp_axis", "gather_whole", "lane_rules", "grad_all_reduce",
    "shared_all_reduce",
]


class PartitionSpec(tuple):
    """Torch-free twin of ``jax.sharding.PartitionSpec``: one entry per dim,
    ``None`` (replicated), a mesh axis name, or a tuple of names (the dim
    splits over their product, the first name outermost)."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec

# logical axis -> mesh axis (or tuple of mesh axes); None = replicated
TRAIN_RULES: dict = {
    "batch": "data",
    "seq": None,
    "embed": "data",        # FSDP shard dim of weights
    "embed_no_fsdp": None,
    "vocab": "model",
    "heads": "model",
    "kv_heads": None,       # GQA kv counts are small; replicate
    "head_dim": None,
    "qkv": "model",         # fused (heads*hd [+bias]) output dims
    "mlp": "model",
    "experts": "model",     # EP == TP axis
    "expert_mlp": None,
    "ssm_inner": "model",
    "ssm_state": None,
    "ssm_heads": "model",
    "layers": None,
    "conv": None,
    "cache_seq": "model",   # decode KV/conv caches: sequence over model
}

POD_TRAIN_RULES = dict(TRAIN_RULES)
POD_TRAIN_RULES.update({
    "batch": ("pod", "data"),
    "embed": ("pod", "data"),   # FSDP spans pods
})


def axis_names(mesh) -> tuple:
    """The mesh's axis names; ``()`` for ``mesh=None`` or an object without
    any (the reference's ``getattr(mesh, "axis_names", ())``)."""
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names) if names is not None else tuple(getattr(mesh, "axis_names", ()))


def axis_sizes(mesh) -> dict:
    """``{axis name: size}`` of a ``DeviceMesh`` or a mesh-like object."""
    if mesh is None:
        return {}
    if hasattr(mesh, "mesh_dim_names"):
        return {n: mesh.size(i) for i, n in enumerate(mesh.mesh_dim_names)}
    return dict(mesh.shape)


def _as_axes(entry) -> tuple:
    """A spec entry as a tuple of mesh axis names."""
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def axis_size(mesh, axes) -> int:
    """Product of the sizes of ``axes`` (a name, a tuple of names, or None);
    an axis the mesh lacks counts 1 (replicated), as the rules' ``model``
    on an FSDP-only mesh."""
    sizes = axis_sizes(mesh)
    return math.prod(sizes.get(a, 1) for a in _as_axes(axes))


def axis_index(mesh, axes) -> int:
    """This rank's coordinate along ``axes`` taken as one axis (row-major,
    the first name outermost): ``jax.lax.axis_index`` over a tuple.  An
    abstract mesh gives the coordinate it was made with."""
    idx = 0
    for a in _as_axes(axes):
        idx = idx * mesh.size(axis_names(mesh).index(a)) + mesh.get_local_rank(a)
    return idx


def tp_axis(mesh) -> Optional[str]:
    """The tensor-parallel mesh axis (the rules' ``qkv`` / ``mlp`` /
    ``vocab``), or None on a mesh without one."""
    return "model" if "model" in axis_names(mesh) else None


def fsdp_axes(mesh) -> tuple:
    """Mesh axes weights FSDP-shard (and all-gather) over: ``("data",)``, or
    ``("pod", "data")`` when FSDP spans pods; ``()`` for ``mesh=None``."""
    names = axis_names(mesh)
    cand = ("pod", "data") if "pod" in names else ("data",)
    return tuple(a for a in cand if a in names)


class Rules:
    """Logical-axis table; ``axis_names`` (set by :func:`rules_for_mesh`)
    are the mesh axes the table may name, which :func:`constrain` checks,
    and ``mesh`` the mesh :func:`constrain` places on (the reference's
    mesh context)."""

    def __init__(self, table: dict, axis_names: Optional[tuple] = None, mesh=None):
        self.table = dict(table)
        self.axis_names = axis_names
        self.mesh = mesh

    def __call__(self, axes) -> PartitionSpec:
        return spec_for_axes(axes, self.table)


def rules_for_mesh(mesh, global_batch: Optional[int] = None) -> Rules:
    """The reference's rules for ``mesh``; a ``global_batch`` the data axes
    do not divide replicates the batch."""
    names = axis_names(mesh)
    table = dict(POD_TRAIN_RULES if "pod" in names else TRAIN_RULES)
    if mesh is not None and global_batch is not None:
        if global_batch % axis_size(mesh, table["batch"]):
            table["batch"] = None
    # a mesh-like stand-in (axis names and sizes, no rank coordinate) can
    # only be checked against, not placed on
    live = mesh if hasattr(mesh, "get_local_rank") else None
    return Rules(table, names if mesh is not None else None, live)


def lane_rules(mesh, rules: Optional[Rules], batch: int) -> Rules:
    """The paged layout's rules for a lane whose batch is ``batch`` rows:
    ``rules`` (by default the mesh's) with the batch over its data axes
    where they divide it, else whole on every rank, as
    ``rules_for_mesh(mesh, global_batch=batch)`` says.  The reference's
    GSPMD pads a batch of 1 over data = 2 instead; here every rank then
    computes the one row."""
    table = dict((rules or rules_for_mesh(mesh)).table)
    if table.get("batch") is not None and batch % axis_size(mesh, table["batch"]):
        table["batch"] = None
    live = mesh if hasattr(mesh, "get_local_rank") else None
    return Rules(table, axis_names(mesh), live)


def spec_for_axes(axes, table: dict) -> PartitionSpec:
    """('embed', 'mlp') -> PartitionSpec('data', 'model') under the rules."""
    return P(*(None if a is None else table.get(a, None) for a in axes))


def shard_slice(x: torch.Tensor, spec, mesh) -> torch.Tensor:
    """This rank's block of the global tensor ``x`` under ``spec`` (dims the
    spec leaves out are whole).  A dim its axes do not divide raises."""
    for dim, entry in enumerate(spec):
        n = axis_size(mesh, entry)
        if n == 1:
            continue
        if x.shape[dim] % n:
            raise ValueError(
                f"dim {dim} of size {x.shape[dim]} (shape {tuple(x.shape)}) is not "
                f"divisible by mesh axes {_as_axes(entry)} (size {n})")
        x = x.chunk(n, dim=dim)[axis_index(mesh, entry)]
    return x.contiguous()


def shard_leaf(mesh, x: torch.Tensor, axes, table: Optional[dict] = None):
    """This rank's shard of one global tensor under its logical ``axes``
    (the default table is :data:`TRAIN_RULES`); ``mesh=None`` passes it."""
    if mesh is None:
        return x
    return shard_slice(x, spec_for_axes(axes, table or TRAIN_RULES), mesh)


@dataclasses.dataclass(frozen=True)
class Placement:
    """What a placed tensor holds: this rank's block of a tensor of global
    ``shape`` under ``spec`` on a mesh of ``mesh_shape`` (``((axis, size),
    ...)``); ``axes`` are its logical axes where it is a parameter or a
    cache leaf (the rules' names), else None."""

    shape: tuple
    spec: PartitionSpec
    mesh_shape: tuple
    axes: Optional[tuple] = None

    @property
    def parts(self) -> int:
        """How many blocks the global tensor is cut into."""
        sizes = dict(self.mesh_shape)
        return math.prod(sizes.get(a, 1) for e in self.spec for a in _as_axes(e))

    def drop_lead(self) -> "Placement":
        """The placement of ``t[g]``: a whole leading (stacked-layer) dim
        indexed away."""
        if self.spec and self.spec[0] is not None:
            raise ValueError(f"indexing a sharded leading dim ({self.spec[0]})")
        return Placement(self.shape[1:], P(*self.spec[1:]), self.mesh_shape,
                         None if self.axes is None else self.axes[1:])


def place(t: torch.Tensor, mesh, spec, shape=None, axes=None) -> torch.Tensor:
    """``t`` as this rank's block of a tensor of global ``shape`` (default:
    ``t``'s shape times the spec's axis sizes) under ``spec``: a view of it
    (the same storage) that carries the :class:`Placement`, so the caller's
    tensor object is never marked."""
    spec = P(*spec) + P(*(None,) * (t.dim() - len(spec)))
    t = t.view_as(t)
    if shape is None:
        shape = tuple(n * axis_size(mesh, e) for n, e in zip(t.shape, spec))
    t._placement = Placement(tuple(shape), spec, tuple(axis_sizes(mesh).items()),
                             None if axes is None else tuple(axes))
    return t


def placement(t) -> Optional[Placement]:
    """The :class:`Placement` :func:`place` recorded on ``t``, or None (a
    whole tensor, or no tensor)."""
    return getattr(t, "_placement", None)


def is_sharded(t) -> bool:
    """Does ``t`` hold a block of a larger tensor (a placement cut in more
    than one part)?"""
    pl = placement(t)
    return pl is not None and pl.parts > 1


def place_tree(tree, specs, mesh, device=None):
    """Cut every tensor of ``tree`` (whole) to this rank's block under the
    matching spec of ``specs`` (a tree of the same shape, or one spec for
    all) and :func:`place` it; ``device`` moves each leaf first."""
    def cut(x, spec):
        if device is not None:
            x = x.to(device)
        return place(shard_slice(x, spec, mesh), mesh, spec, tuple(x.shape))
    return _map_spec(cut, tree, specs)


def gather_whole(t: torch.Tensor, mesh) -> torch.Tensor:
    """The whole tensor of a placed block: all-gathered over every axis its
    placement splits it along (a tensor without a placement is whole)."""
    pl = placement(t)
    if pl is None:
        return t
    for dim, entry in enumerate(pl.spec):
        if axis_size(mesh, entry) > 1:
            t = all_gather(t, mesh, entry, dim)
    return t


def check_axes(x: torch.Tensor, axes, rules: Optional[Rules]) -> torch.Tensor:
    """The replicated layout's ``with_sharding_constraint``: checks that
    ``axes`` name one logical axis per dim, each mapped to axes of the
    rules' mesh, and moves nothing."""
    if rules is None:
        return x
    if len(axes) != x.dim():
        raise ValueError(f"constrain: {len(axes)} logical axes {tuple(axes)} "
                         f"for a {x.dim()}-d tensor of shape {tuple(x.shape)}")
    if rules.axis_names is not None:
        for entry in rules(axes):
            missing = [a for a in _as_axes(entry) if a not in rules.axis_names]
            if missing:
                raise ValueError(f"constrain: logical axes {tuple(axes)} map to "
                                 f"{missing}, not axes of the mesh "
                                 f"{rules.axis_names}")
    return x


def constrain(x: torch.Tensor, axes, rules: Optional[Rules]) -> torch.Tensor:
    """The reference's ``with_sharding_constraint`` by logical axes: this
    rank's block of ``x`` under ``rules(axes)`` on the rules' mesh.  A whole
    ``x`` (no :class:`Placement`) is sliced; a placed one moves by
    collectives: every dim whose axes differ from the target's is gathered
    whole, then every such dim is sliced to the target's block.  The result is placed.
    Checked as :func:`check_axes` checks; without rules or without a mesh
    in them nothing moves."""
    check_axes(x, axes, rules)
    if rules is None or rules.mesh is None:
        return x
    mesh, target = rules.mesh, rules(axes)
    src = placement(x)
    shape = tuple(x.shape) if src is None else src.shape
    have = P(*(None,) * x.dim()) if src is None else src.spec
    if src is not None and len(shape) != x.dim():
        raise ValueError(f"constrain: the tensor's placement is of a "
                         f"{len(shape)}-d tensor, it has {x.dim()} dims")
    out = x
    moves = [dim for dim, (a, b) in enumerate(zip(have, target))
             if _as_axes(a) != _as_axes(b)]
    for dim in moves:           # every moving dim whole first: an axis may
        if axis_size(mesh, have[dim]) > 1:      # move from one dim to another
            out = all_gather(out, mesh, have[dim], dim)
    for dim in moves:
        b = target[dim]
        n = axis_size(mesh, b)
        if n > 1:
            if out.shape[dim] % n:
                raise ValueError(
                    f"constrain: dim {dim} of size {out.shape[dim]} (shape "
                    f"{shape}) is not divisible by mesh axes {_as_axes(b)} "
                    f"(size {n})")
            out = out.chunk(n, dim=dim)[axis_index(mesh, b)]
    if out is x and src is not None:
        return x
    return place(out.contiguous(), mesh, target, shape)


def batch_spec(rules: Optional[Rules], extra_axes: int = 1) -> PartitionSpec:
    """(batch, seq, ...) activation spec."""
    if rules is None:
        return P()
    return rules(("batch",) + (None,) * extra_axes)


# ------------------------------------------------------------ collectives --

def _group(mesh, axes):
    """The process group of ``axes`` (one axis, or several flattened)."""
    axes = _as_axes(axes)
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    return mesh[axes]._flatten("_".join(axes)).get_group()


def _stand_in(mesh, x: torch.Tensor, what: str) -> bool:
    """Is ``mesh`` abstract?  Then ``x`` must be a ``meta`` tensor: the
    stand-in shapes results and never takes the place of a real group on
    real data."""
    if not getattr(mesh, "abstract", False):
        return False
    if x.device.type != "meta":
        raise ValueError(f"{what}: {mesh!r} has no process group; it takes meta "
                         f"tensors only, got one on {x.device}")
    return True


def _sync(x: torch.Tensor, mesh, axes) -> None:
    """Gloo copies a CUDA tensor through the host: finish the kernels that
    write it first."""
    import torch.distributed as dist
    if x.is_cuda and dist.get_backend(_group(mesh, axes)) == "gloo":
        torch.cuda.current_stream(x.device).synchronize()


def _gather_raw(x: torch.Tensor, mesh, axes, dim: int, n: int) -> torch.Tensor:
    """The ranks' blocks of ``x`` concatenated along ``dim`` (recorded)."""
    out = x
    if _stand_in(mesh, x, "all_gather"):
        if n > 1:
            out = torch.cat([x] * n, dim=dim)
    elif n > 1:
        import torch.distributed as dist
        x = x.contiguous()
        _sync(x, mesh, axes)
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x, group=_group(mesh, axes))
        out = torch.cat(parts, dim=dim)
    if hooks.active is not None:    # a dataflow trace records the collective
        hooks.active.collective("all_gather", x, n, out)
    return out


def _sum_raw(x: torch.Tensor, mesh, axes, n: int) -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``axes``, a new tensor
    (recorded)."""
    out = x
    stand_in = _stand_in(mesh, x, "all_reduce")
    if n > 1:
        out = x.clone()
        if not stand_in:
            import torch.distributed as dist
            _sync(out, mesh, axes)
            dist.all_reduce(out, group=_group(mesh, axes))
    if hooks.active is not None:
        hooks.active.collective("psum", x, n, out)
    return out


class _Gather(torch.autograd.Function):
    """All-gather; its backward sums the gradient over the same ranks and
    keeps this rank's block (each rank's use of the gathered tensor gives
    part of its gradient)."""

    @staticmethod
    def forward(ctx, x, mesh, axes, dim, n):
        ctx.args = (mesh, axes, dim, n)
        return _gather_raw(x, mesh, axes, dim, n)

    @staticmethod
    def backward(ctx, g):
        mesh, axes, dim, n = ctx.args
        g = _sum_raw(g.contiguous(), mesh, axes, n)
        return g.chunk(n, dim=dim)[axis_index(mesh, axes)], None, None, None, None


class _Sum(torch.autograd.Function):
    """All-reduce (sum, or mean: the sum divided by ``div``); its backward
    passes the gradient on (divided alike): every rank holds the whole
    result."""

    @staticmethod
    def forward(ctx, x, mesh, axes, n, div):
        ctx.div = div
        out = _sum_raw(x, mesh, axes, n)
        return out / div if div != 1 else out

    @staticmethod
    def backward(ctx, g):
        return (g / ctx.div if ctx.div != 1 else g), None, None, None, None


class _GradSum(torch.autograd.Function):
    """Identity; its backward sums the gradient over the ranks."""

    @staticmethod
    def forward(ctx, x, mesh, axes, n):
        ctx.args = (mesh, axes, n)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        mesh, axes, n = ctx.args
        return _sum_raw(g.contiguous(), mesh, axes, n), None, None, None


def _differentiable(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


def all_gather(x: torch.Tensor, mesh, axes, dim: int) -> torch.Tensor:
    """``jax.lax.all_gather(x, axes, axis=dim, tiled=True)``: the ranks'
    blocks concatenated along ``dim`` in the order of :func:`axis_index`
    (on an abstract mesh, ``n`` copies of the ``meta`` block).  Autograd
    takes its transpose: the gradient summed over ``axes``, this rank's
    block of it."""
    n = axis_size(mesh, axes)
    dim = dim % max(x.dim(), 1)
    if n > 1 and _differentiable(x):
        return _Gather.apply(x, mesh, axes, dim, n)
    return _gather_raw(x, mesh, axes, dim, n)


def gather_out(y: torch.Tensor, mesh, axes, dim: int) -> torch.Tensor:
    """A result's global-out re-assembly: :func:`all_gather`, recorded by a
    dataflow trace as ``out_gather``.  It is the twin of ``shard_map``'s
    ``out_specs``, which the reference's program holds as a sharded value
    and not as a collective, so it is no gather-class collective of the
    program (``analysis.dataflow``)."""
    if hooks.active is None:
        return all_gather(y, mesh, axes, dim)
    trace = hooks.active
    with hooks.paused():
        out = all_gather(y, mesh, axes, dim)
    trace.collective("out_gather", y, axis_size(mesh, axes), out)
    return out


def all_reduce(x: torch.Tensor, mesh, axes, op: str = "sum") -> torch.Tensor:
    """``psum`` (``op="sum"``) or ``pmean`` (``"mean"``) over ``axes``; the
    input is left as it was (on an abstract mesh the sum is a ``meta``
    clone).  Autograd passes the gradient through (divided by the ranks'
    count for ``"mean"``)."""
    n = axis_size(mesh, axes)
    div = n if op == "mean" else 1
    if n > 1 and _differentiable(x):
        return _Sum.apply(x, mesh, axes, n, div)
    out = _sum_raw(x, mesh, axes, n)
    return out / div if div != 1 else out


def grad_all_reduce(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """Identity in the forward; in the backward the gradient summed over
    ``axes``: the input of column-parallel products, each of whose ranks
    contributes part of its gradient (Megatron's ``f``).  Nothing runs,
    and ``x`` comes back, where autograd does not track it."""
    n = axis_size(mesh, axes)
    if n > 1 and _differentiable(x):
        return _GradSum.apply(x, mesh, axes, n)
    return x


def shared_all_reduce(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """``psum`` over ``axes`` with its true transpose: the backward sums the
    gradient over ``axes`` too.  For a sum that each rank then uses on its
    own block (the gated norm's sum of squares over ``model``), whose
    gradient each rank holds only its part of; :func:`all_reduce` passes
    the gradient on as it is, which is right only where everything after
    the sum is the same on every rank."""
    return all_reduce(grad_all_reduce(x, mesh, axes), mesh, axes)


def _map_spec(fn, tree, spec):
    """Apply ``fn(leaf, spec)`` over a tensor tree; ``spec`` is one spec for
    the whole tree or a dict of specs matching a dict."""
    if isinstance(tree, dict):
        return {k: _map_spec(fn, v, spec[k] if isinstance(spec, dict) else spec)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_spec(fn, v, s) for v, s in zip(tree, spec))
    return fn(tree, spec) if isinstance(tree, torch.Tensor) else tree


def _gather_out(y: torch.Tensor, spec, mesh) -> torch.Tensor:
    for dim, entry in enumerate(spec):
        y = gather_out(y, mesh, entry, dim)
    return y


def shard_map(f, mesh, in_specs, out_specs):
    """Twin of ``jax.shard_map`` under the global-in, global-out contract
    of the replicated layout: the returned function takes global
    (replicated) arguments, enters ``f`` on this rank's blocks of them
    (``in_specs``, one per argument; a dict of specs for a dict argument),
    and all-gathers ``f``'s result back to global along ``out_specs``.
    Inside ``f`` the collectives are :func:`all_gather` /
    :func:`all_reduce` / :func:`axis_index` on ``mesh``.  The sharded
    serving layout's blocks-in, blocks-out contract is carried by the
    ``sharded:*`` variants' ``spmd`` branches (``engine.sharded``)."""
    def fn(*args):
        local_args = [_map_spec(lambda x, s: shard_slice(x, s, mesh), a, s)
                      for a, s in zip(args, in_specs)]
        out = f(*local_args)
        return _map_spec(lambda y, s: _gather_out(y, s, mesh), out, out_specs)
    return fn
