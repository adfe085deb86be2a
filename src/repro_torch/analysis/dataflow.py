"""Packed-dataflow verification: records one eager run of a port function —
every ATen op, every kernel call and every collective — and proves it
moves only packed StruM bytes where it claims to (twin of
``repro.analysis.dataflow``).

A jaxpr has no counterpart in eager PyTorch, so :func:`trace_dataflow`
runs the function once under three recorders:

* a ``TorchDispatchMode`` records every ATen op (name, input and output
  tensors, dtypes, shapes);
* ``kernels.hooks`` records each call of a kernel wrapper (K1-K11, on the
  card or on its plain route) as one event with the field tensors it is
  handed: the counterpart of a ``pallas_call`` equation.  The ops the call
  runs inside belong to it;
* the same slot records ``models.sharding``'s collectives with their
  operand bytes and gather width (``all_gather``; ``out_gather``, the
  global-out re-assembly that the reference holds as ``shard_map``'s
  ``out_specs`` and not as a collective; ``psum``).

Taints follow the reference (``dataflow.py``'s lattice): every input leaf
reached through a ``mask`` / ``hi`` / ``lo`` key is PACKED (``scale``
SCALE, raw fp cache ``pages`` FPPAGE), tagged with its path.  They spread
through op and call events by tensor storage, so views inherit them.  The
allocator reuses an address as soon as its tensor dies, so the trace holds
every tensor it has seen until it ends: a storage's taint never lands on
an unrelated tensor.

A read of a stored leaf is located by its *region*: ``(leaf, field,
storage offset)`` — the offset tells the layers of a stacked leaf apart.
A **decode site** is a kernel call that is handed a PACKED field, or,
outside any call, the first op that turns PACKED integers into floats; its
outputs are DECODED.  View ops read nothing.  A gather-class op
(``index_select``, ``index``, ``gather``, ``embedding``) on a stored leaf,
or a kernel call on the card that reads pools by page id, is a pool read
whose bytes are what the sealed pools cost the step.

The invariants (:func:`verify`) are the reference's:
``dataflow/fp-collective``, ``dataflow/eq1-bytes``,
``dataflow/decode-multiplicity`` (a region read by more than one decode
site) and ``dataflow/fp-page``.
"""
from __future__ import annotations

import dataclasses
import inspect
import math
from typing import Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.analysis.report import Report
from repro_torch.kernels import hooks

__all__ = ["Taint", "CollectiveOp", "Event", "DataflowTrace", "trace_dataflow",
           "collective_stats", "verify", "PAYLOAD_KEYS", "GATHER_COLLECTIVES"]

PAYLOAD_KEYS = ("mask", "hi", "lo")
SCALE_KEY = "scale"
PAGES_KEY = "pages"   # raw fp pages of a passthrough cache pool
#: collectives that *move* operand bytes to other devices (a psum reduces
#: partials and is not byte-expansion; ``out_gather`` re-assembles a
#: global-out result)
GATHER_COLLECTIVES = frozenset({"all_gather", "all_to_all", "ppermute"})
#: gather-class *read* ops: lookups into pool (or leaf) tensors
GATHER_READS = frozenset({"aten.index_select.default", "aten.index.Tensor",
                          "aten.gather.default", "aten.embedding.default"})

PACKED, SCALE, DECODED, FPPAGE = "packed", "scale", "decoded", "fp_page"
_RANK = {None: 0, SCALE: 1, FPPAGE: 2, PACKED: 3, DECODED: 4}


@dataclasses.dataclass(frozen=True)
class Taint:
    """Lattice value: ``state``, the payload-leaf tags it derives from, and
    the stored regions ``(tag, field, storage offset)`` behind it.

    ``root`` marks the taint of an input leaf itself (and its views): a
    read of it reads stored payload bytes out of a leaf or pool."""

    state: str
    tags: frozenset = frozenset()
    root: bool = False
    regions: frozenset = frozenset()


def _join(taints) -> Optional[Taint]:
    taints = [t for t in taints if t is not None]
    if not taints:
        return None
    state = max((t.state for t in taints), key=_RANK.__getitem__)
    return Taint(state, frozenset().union(*(t.tags for t in taints)),
                 regions=frozenset().union(*(t.regions for t in taints)))


@dataclasses.dataclass
class CollectiveOp:
    """One collective (or pool read) with byte accounting and operand taint."""

    primitive: str
    shape: tuple
    dtype: str
    operand_bytes: int
    gathered_bytes: int
    state: Optional[str]          # taint state of the operand (None = clean)
    tags: tuple
    root: bool = False            # operand is a stored input leaf itself


@dataclasses.dataclass
class Event:
    """One recorded op, kernel call or collective, in program order."""

    kind: str                     # "op" | "kernel" | "collective"
    name: str
    inputs: tuple                 # ((shape, dtype), ...) of its tensor inputs
    route: str = ""               # kernel calls: "cuda" | "plain"
    reads: dict = dataclasses.field(default_factory=dict)
    # kernel calls: argument name -> regions of the stored leaves it is handed


@dataclasses.dataclass
class DataflowTrace:
    """Everything :func:`trace_dataflow` learned about one recorded call."""

    collectives: list
    decode_sites: list            # (event index, regions) per decode site
    out_taints: list
    gathers: list = dataclasses.field(default_factory=list)
    events: list = dataclasses.field(default_factory=list)
    read_regions: dict = dataclasses.field(default_factory=dict)
    # region -> indices of the (non-view) events handed it

    def region_sites(self) -> dict:
        """region -> decode-site ids that read it."""
        out: dict = {}
        for site, regions in self.decode_sites:
            for r in regions:
                out.setdefault(r, set()).add(site)
        return out

    def kernel_calls(self, name: Optional[str] = None) -> list:
        return [e for e in self.events if e.kind == "kernel"
                and (name is None or e.name == name)]

    def signature(self) -> tuple:
        """The ordered (event, input shapes and dtypes) of the call: one
        lane's shape signature (``analysis.recompile``)."""
        return tuple((e.name, e.inputs) for e in self.events)

    def stats(self, mesh=None) -> dict:
        """The ``all_gather_stats`` dict (ops / operand_bytes /
        gathered_bytes [, global_operand_bytes]) —
        :func:`repro_torch.telemetry.all_gather_stats` returns it."""
        ops = [{"shape": o.shape, "dtype": o.dtype,
                "operand_bytes": o.operand_bytes,
                "gathered_bytes": o.gathered_bytes}
               for o in self.collectives if o.primitive == "all_gather"]
        out = {"ops": ops,
               "operand_bytes": int(sum(o["operand_bytes"] for o in ops)),
               "gathered_bytes": int(sum(o["gathered_bytes"] for o in ops))}
        if mesh is not None:
            from repro_torch.models.sharding import axis_sizes
            out["global_operand_bytes"] = out["operand_bytes"] * math.prod(
                axis_sizes(mesh).values())
        return out

    def packed_operand_bytes(self) -> int:
        return int(sum(o.operand_bytes for o in self.collectives
                       if o.primitive in GATHER_COLLECTIVES
                       and o.state == PACKED))

    def sealed_gather_packed_bytes(self) -> int:
        """Bytes the recorded step's pool reads take out of PACKED-state
        *stored leaves* — the sealed-cache HBM read per step."""
        return int(sum(o.gathered_bytes for o in self.gathers
                       if o.state == PACKED and o.root))


def _live_pages(ids: torch.Tensor, n_valid: Optional[torch.Tensor], n_pages: int) -> int:
    """The (slot, page) entries of table ``ids`` (B, P) that a paged kernel
    reads: a page id in ``[0, n_pages)`` at a page slot below the slot's
    ``n_valid`` (every slot when it is None)."""
    ids = ids.detach().to("cpu", torch.long)
    live = (ids >= 0) & (ids < n_pages)
    if n_valid is not None:
        nv = n_valid.detach().to("cpu", torch.long).reshape(-1, 1)
        live &= torch.arange(ids.shape[1])[None, :] < nv
    return int(live.sum())


def _key_name(k) -> str:
    """A path key as the reference names it (a namedtuple field without
    the port walker's leading dot)."""
    k = str(k)
    return k[1:] if k.startswith(".") else k


def _leaf_taint(path) -> Optional[Taint]:
    """Payload taint of an input leaf from its path: the last entry names
    the field, everything before it is the leaf's tag."""
    if not path:
        return None
    field = _key_name(path[-1])
    tag = "/".join(_key_name(p) for p in path[:-1]) or "<root>"
    state = {SCALE_KEY: SCALE, PAGES_KEY: FPPAGE}.get(
        field, PACKED if field in PAYLOAD_KEYS else None)
    return None if state is None else Taint(state, frozenset({tag}), root=True,
                                            regions=frozenset({(tag, field, -1)}))


def _skey(t: torch.Tensor):
    st = t.untyped_storage()
    return None if st.nbytes() == 0 else (t.device, st.data_ptr())


def _dtname(dtype) -> str:
    """A dtype as numpy (and the reference's reports) name it."""
    return str(dtype).replace("torch.", "")


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class _Tracer(TorchDispatchMode):
    """The recorders of one :func:`trace_dataflow` call."""

    def __init__(self):
        super().__init__()
        self.taints: dict = {}        # storage key -> Taint
        self.held: list = []          # every tensor seen, alive until the end
        self.events: list = []
        self.collectives: list = []
        self.gathers: list = []
        self.decode_sites: list = []
        self.read_regions: dict = {}
        self._kernel: Optional[int] = None   # the open kernel call's event

    # -- taints by storage ----------------------------------------------
    def seed(self, t: torch.Tensor, taint: Taint) -> None:
        key = _skey(t)
        if key is not None:
            self.held.append(t)
            self.taints[key] = taint

    def read(self, t: torch.Tensor) -> Optional[Taint]:
        """The taint a use of ``t`` sees: a stored leaf's names its region."""
        key = _skey(t)
        taint = self.taints.get(key) if key is not None else None
        if taint is None or not taint.root:
            return taint
        (tag, field, _), = taint.regions
        return dataclasses.replace(
            taint, regions=frozenset({(tag, field, t.storage_offset())}))

    def _set(self, t: torch.Tensor, taint: Optional[Taint]) -> None:
        key = _skey(t)
        if key is None:
            return
        self.held.append(t)
        old = self.taints.get(key)
        if old is not None and old.root:
            return                    # a stored leaf stays what it is
        if taint is not None:
            self.taints[key] = taint if old is None else _join([old, taint])

    def _note_reads(self, idx: int, taints) -> None:
        for taint in taints:
            if taint is not None and taint.root:
                for r in taint.regions:
                    self.read_regions.setdefault(r, []).append(idx)

    # -- ATen ops --------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ins = [a for a in tree_flatten((args, kwargs))[0] if isinstance(a, torch.Tensor)]
        outs = [o for o in tree_flatten(out)[0] if isinstance(o, torch.Tensor)]
        self.held.extend(ins)
        idx = len(self.events)
        name = str(func)
        self.events.append(Event("op", name, tuple((tuple(t.shape), str(t.dtype))
                                                   for t in ins)))
        if func.is_view:
            return out                # shares its input's storage, and taint
        in_t = [self.read(t) for t in ins]
        self._note_reads(idx, in_t)
        joined = _join(in_t)
        if name in GATHER_READS and ins and in_t[0] is not None:
            src, t0 = ins[0], in_t[0]
            self.gathers.append(CollectiveOp(
                primitive=name, shape=tuple(outs[0].shape), dtype=_dtname(outs[0].dtype),
                operand_bytes=_nbytes(src), gathered_bytes=_nbytes(outs[0]),
                state=t0.state, tags=tuple(sorted(t0.tags)), root=t0.root))
        if joined is not None and joined.state in (PACKED, SCALE) \
                and self._kernel is None:
            packed = [t for t, x in zip(in_t, ins) if t is not None
                      and t.state == PACKED and not x.is_floating_point()]
            if packed and any(o.is_floating_point() for o in outs):
                regions = frozenset().union(*(t.regions for t in packed))
                joined = Taint(DECODED, joined.tags, regions=joined.regions)
                self.decode_sites.append((idx, regions))
        for o in outs:
            self._set(o, joined)
        return out

    # -- kernel calls (kernels.hooks) ------------------------------------
    def kernel(self, name: str, fn, *args, **kwargs):
        bound = inspect.signature(fn).bind(*args, **kwargs).arguments
        named = {k: v for k, v in bound.items() if isinstance(v, torch.Tensor)}
        route = "cuda" if any(t.device.type == "cuda" for t in named.values()) \
            else "plain"
        idx = len(self.events)
        in_t = {k: self.read(t) for k, t in named.items()}
        ev = Event("kernel", name, tuple((tuple(t.shape), str(t.dtype))
                                         for t in named.values()), route=route,
                   reads={k: taint.regions for k, taint in in_t.items()
                          if taint is not None and taint.root})
        self.events.append(ev)
        self.held.extend(named.values())
        self._note_reads(idx, in_t.values())
        ids = bound.get("page_ids")
        if route == "cuda" and ids is not None:
            # the kernel reads the pools by page id itself, and only the live
            # entries of the table: an id in the pool, below the slot's
            # n_valid sealed pages (strum_attention.cu, the split kernel's
            # page list)
            for k, t in named.items():
                taint = in_t[k]
                if taint is not None and taint.root and k != "page_ids":
                    n = _live_pages(ids, bound.get("n_valid"), t.shape[0])
                    per_page = _nbytes(t) // max(t.shape[0], 1)
                    self.gathers.append(CollectiveOp(
                        primitive=name, shape=(n,) + tuple(t.shape[1:]),
                        dtype=_dtname(t.dtype), operand_bytes=_nbytes(t),
                        gathered_bytes=n * per_page, state=taint.state,
                        tags=tuple(sorted(taint.tags)), root=True))
        outer, self._kernel = self._kernel, idx
        try:
            with hooks.paused():
                out = fn(*args, **kwargs)
        finally:
            self._kernel = outer
        outs = [o for o in tree_flatten(out)[0] if isinstance(o, torch.Tensor)]
        joined = _join(in_t.values())
        packed = [t for k, t in in_t.items() if t is not None and t.state == PACKED
                  and not named[k].is_floating_point()]
        if packed and any(o.is_floating_point() for o in outs):
            regions = frozenset().union(*(t.regions for t in packed))
            joined = Taint(DECODED, joined.tags, regions=joined.regions)
            self.decode_sites.append((idx, regions))
        for o in outs:
            key = _skey(o)
            if key is not None and joined is not None:
                self.held.append(o)
                self.taints[key] = joined
        return out

    # -- collectives (models.sharding) -----------------------------------
    def collective(self, primitive: str, x: torch.Tensor, width: int,
                   out: Optional[torch.Tensor] = None) -> None:
        t = self.read(x)
        nbytes = _nbytes(x)
        self.events.append(Event("collective", primitive,
                                 ((tuple(x.shape), str(x.dtype)),)))
        self.held.append(x)
        self.collectives.append(CollectiveOp(
            primitive=primitive, shape=tuple(x.shape), dtype=_dtname(x.dtype),
            operand_bytes=nbytes, gathered_bytes=nbytes * width,
            state=t.state if t else None, tags=tuple(sorted(t.tags)) if t else (),
            root=bool(t and t.root)))
        if out is not None and t is not None and _skey(out) != _skey(x):
            self._set(out, Taint(t.state, t.tags, regions=t.regions))


def _flat_inputs(args, kwargs) -> list:
    from repro_torch.core.apply import _flatten_with_path
    return [(path, leaf) for path, leaf in _flatten_with_path((args, kwargs))
            if isinstance(leaf, torch.Tensor)]


def _record(fn, *args, **kwargs) -> tuple:
    """``(DataflowTrace, fn's output)`` of one recorded call."""
    tracer = _Tracer()
    for path, leaf in _flat_inputs(args, kwargs):
        t = _leaf_taint(path)
        if t is not None:
            tracer.seed(leaf, t)
    if hooks.active is not None:
        raise RuntimeError("trace_dataflow: a trace is already active")
    hooks.active = tracer
    try:
        with tracer:
            out = fn(*args, **kwargs)
    finally:
        hooks.active = None
    outs = [o for o in tree_flatten(out)[0] if isinstance(o, torch.Tensor)]
    trace = DataflowTrace(
        collectives=tracer.collectives, decode_sites=tracer.decode_sites,
        out_taints=[_join(tracer.read(o) for o in outs)], gathers=tracer.gathers,
        events=tracer.events, read_regions=tracer.read_regions)
    return trace, out


def trace_dataflow(fn, *args, **kwargs) -> DataflowTrace:
    """Run ``fn(*args, **kwargs)`` once under the recorders and spread
    payload taints through what it did.  Input tagging follows the paths
    of ``(args, kwargs)`` — any tensor under a ``mask``/``hi``/``lo`` key is
    PACKED, under ``scale`` SCALE, under ``pages`` FPPAGE."""
    return _record(fn, *args, **kwargs)[0]


def collective_stats(fn, *args, mesh=None, **kwargs) -> dict:
    """Byte accounting of the collectives (the ``all_gather_stats``
    contract), read off one recorded call."""
    return trace_dataflow(fn, *args, **kwargs).stats(mesh=mesh)


def verify(fn, *args, location: str = "<fn>", mesh=None,
           expected_payload_bytes: Optional[int] = None,
           cfg=None, k_dim: Optional[int] = None,
           n_out: Optional[int] = None,
           expected_gather_packed_bytes: Optional[int] = None,
           forbid_fp_pages: bool = False, trace: Optional[DataflowTrace] = None,
           **kwargs) -> Report:
    """Run the dataflow pass over ``fn`` and report invariant violations.

    ``expected_payload_bytes`` (usually ``mask + hi + lo`` bytes of the
    *global* leaf) arms the Eq.-1 byte check against the gathered packed
    bytes; ``cfg`` (+ ``k_dim``/``n_out``) pins that payload to the paper's
    ``K x N x compression_ratio``.  ``expected_gather_packed_bytes`` arms
    the cache-side check: the bytes the step's pool reads take out of
    PACKED pools must equal it.  ``forbid_fp_pages=True`` also errors on
    any FPPAGE pool read and on re-gathers of decoded pool bytes (data
    decoded from the pools alone).
    ``trace`` reuses a recorded call instead of running ``fn`` again.
    """
    report = Report()
    trace = trace if trace is not None else trace_dataflow(fn, *args, **kwargs)

    for op in trace.collectives:
        if op.primitive not in GATHER_COLLECTIVES:
            continue
        where = (f"{location}: {op.primitive} {op.shape} {op.dtype}"
                 + (f" tags={list(op.tags)}" if op.tags else ""))
        if op.state == DECODED:
            report.add("error", "dataflow/fp-collective", where,
                       f"collective moves {op.operand_bytes} decoded fp "
                       f"bytes per device; gather the packed payload and "
                       f"decode after the collective")
        elif op.state is None and op.dtype in ("float32", "bfloat16", "float16"):
            report.add("warning", "dataflow/fp-collective", where,
                       f"collective moves {op.operand_bytes} untagged "
                       f"floating-point bytes per device (dense operand?)")

    if forbid_fp_pages:
        pool_tags = set().union(*(set(o.tags) for o in trace.gathers
                                  if o.root and o.state in (PACKED, FPPAGE)), set())
        for op in trace.gathers:
            where = (f"{location}: {op.primitive} {op.shape} {op.dtype}"
                     + (f" tags={list(op.tags)}" if op.tags else ""))
            if op.state == FPPAGE:
                report.add("error", "dataflow/fp-page", where,
                           f"pool read materializes {op.gathered_bytes} raw "
                           f"fp page bytes; the packed lane must read "
                           f"mask+hi+lo only")
            elif op.state == DECODED and op.tags and set(op.tags) <= pool_tags:
                # decoded pool bytes alone: activations that mixed them with
                # the weights (the hot tails) are no pool re-gather
                report.add("error", "dataflow/fp-page", where,
                           f"pool bytes re-gathered after decode "
                           f"({op.gathered_bytes} fp bytes); gather packed "
                           f"and decode in the kernel")

    for (tag, field, offset), sites in sorted(trace.region_sites().items()):
        if len(sites) > 1:
            report.add("error", "dataflow/decode-multiplicity",
                       f"{location}: {tag}",
                       f"field {field} (storage offset {offset}) decoded by "
                       f"{len(sites)} sites in one call; decode exactly once")

    if expected_payload_bytes is not None:
        n_dev = 1
        if mesh is not None:
            from repro_torch.models.sharding import axis_sizes
            n_dev = math.prod(axis_sizes(mesh).values())
        moved = trace.packed_operand_bytes() * n_dev
        if moved != int(expected_payload_bytes):
            report.add("error", "dataflow/eq1-bytes", location,
                       f"gathers move {moved} global packed bytes, leaf "
                       f"payload is {int(expected_payload_bytes)}")
        if cfg is not None and k_dim is not None and n_out is not None \
                and k_dim % cfg.w == 0:
            eq1 = int(k_dim * n_out * cfg.compression_ratio)
            if int(expected_payload_bytes) != eq1:
                report.add("error", "dataflow/eq1-bytes", location,
                           f"leaf payload {int(expected_payload_bytes)} B "
                           f"!= Eq.-1 prediction {eq1} B "
                           f"(K={k_dim} N={n_out} r="
                           f"{cfg.compression_ratio:.4f})")

    if expected_gather_packed_bytes is not None:
        moved = trace.sealed_gather_packed_bytes()
        if moved != int(expected_gather_packed_bytes):
            report.add("error", "dataflow/eq1-bytes", location,
                       f"pool reads take {moved} packed bytes per recorded "
                       f"step; the sealed pools' mask+hi+lo payload is "
                       f"{int(expected_gather_packed_bytes)}")
    return report
