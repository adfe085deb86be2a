"""Static quantization-error analysis: an abstract interpreter over one eager
run of a port function (twin of ``repro.analysis.numerics``).

Propagates quantization-error intervals and second moments from every StruM
decode site (the PACKED payload leaves, keyed as ``dataflow.py`` keys its
taints) through the program — matmuls, softmax, rms-norm, the flash loop —
to a statically derived per-leaf and end-to-end output-error bound for any
``(params, schedule)`` pair.

Abstract domain (:class:`ErrVal`), the reference's, one value per program
value:

* ``[lo, hi]`` — a *joint* interval: it bounds the value in the fp program
  AND in every (partially-)quantized variant.  Leaf intervals are hulls
  over ``W`` and ``W_hat``; all transfer rules are value-agnostic, so the
  property is preserved by construction.
* ``err[tag]`` — sound per-payload-leaf error: a bound on how much the
  value moves when leaf ``tag`` alone is swapped from ``W`` to ``W_hat``.
  ``sum_t err[tag]`` bounds the fully quantized program, and because the
  interval is joint every ``err[tag]`` is capped at the interval width.
* ``ms`` / ``err2[tag]`` — *estimate* channels (mean square of the value,
  mean-square error per leaf) used by the activation-aware autotune proxy
  (:func:`output_gains`); no soundness claim.
* ``const`` — the exact concrete value (a tensor on its device), tracked
  when an op's inputs are all exact and its output has at most
  ``_CONST_SIZE_LIMIT`` elements: masks, rope tables, one layer of a small
  stacked leaf.

**The walker.**  A jaxpr has no eager twin, so :func:`analyze` runs ``fn``
once under the two recorders ``analysis.dataflow`` uses: a
``TorchDispatchMode`` that sees every ATen op with its inputs and outputs,
and the ``kernels.hooks`` slot through which every kernel wrapper (K1-K11)
hands its call.  Each ATen op is lowered to the reference's primitives (a
``mean`` is a ``reduce_sum`` and a ``div``, a softmax the reference's five
equations, an implicit broadcast the ``broadcast_in_dim`` jnp inserts) and
those go through the reference's 33 transfer rules.  Values live in a table
keyed by tensor storage, and every tensor seen is held until the end, so the
allocator cannot reuse an address under a stale key.  A view of a non-exact
tensor reads its storage's value (the reference's ``slice`` / ``reshape``
rules are pass-through); a view of an exact tensor with a ``const`` takes
the interval of its own elements, as the reference's ``_try_const`` and
``_slice_lead`` give one layer of a scanned stacked leaf.  An in-place op
writes its storage (joining, when it writes part of it).  A matmul kernel
call (K1-K3, K6-K10) is one ``dot``: its payload becomes
``_from_stats(stats[tag])``; K4, K5, K11 go to TOP.  Where the ``torch``
family decodes a payload outside any wrapper, payload-pure markers flow
through the decode ops until the first op that mixes them with program
values, where the payload materializes to its :class:`LeafStats`.

**Departures from the reference.**  There is no ``scan_unroll_limit``: an
eager run has no scan to unroll.  Eager runs follow one branch only, so a
data-dependent op (``topk``, ``sort``, ``argmax``, ``nonzero``,
``masked_select``, an ``.item()``) of a non-exact value goes to TOP with a
``numerics/unsupported-op`` finding; of an exact one it is a constant.  The
flash normalizer is matched across the iterations of the unrolled loop of
``models.attention._chunked_causal`` (no scan to match).  The rms-norm
matcher also accepts the centered form ``(x - mu) * rsqrt(mean((x -
mu)^2) + eps)`` when both ``x - mu`` are the same op on the same inputs
(OLMo's non-parametric LayerNorm): the reference's ``jnp.var`` recomputes
the mean, so its matcher never sees that form.

Four refinements keep the interval domain tight where naive interval
arithmetic explodes: dominated-sub (``x - group_max(x) <= 0``), the
softmax denominator (``>= 1``), the flash normalizer (``l_final >= 1``) and
rms-norm (``|x * rsqrt(mean(x^2) + eps)| <= sqrt(n)``).  All are
tightness-only: on a miss the bound stays sound, just wider.
:attr:`NumericsResult.counts` says how many flash updates and rms products
matched and missed, and how many kernel calls were interpreted.
"""
from __future__ import annotations

import collections
import dataclasses
import inspect
import math
from typing import Optional

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode, _disable_current_modes
from torch.utils._pytree import tree_flatten

from repro_torch.analysis.report import Report
from repro_torch.kernels import hooks

__all__ = ["LeafStats", "ErrVal", "NumericsResult", "leaf_stats_from_plan",
           "analyze", "output_gains", "measured_error", "check_error_budget",
           "per_tensor_bound", "PAYLOAD_KEYS", "SCALE_KEY"]

PAYLOAD_KEYS = ("mask", "hi", "lo")
SCALE_KEY = "scale"

INF = float("inf")
#: largest array the interpreter will materialize for exact const tracking
_CONST_SIZE_LIMIT = 1 << 17
_EXP_CLAMP = 709.0

_PASS_THROUGH = frozenset({
    "broadcast_in_dim", "reshape", "convert_element_type", "squeeze",
    "transpose", "copy", "stop_gradient", "expand_dims",
})


# ---------------------------------------------------------------------------
# leaf statistics


def _f64(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().to("cpu", torch.float64).numpy()
    return np.asarray(t, dtype=np.float64)


@dataclasses.dataclass(frozen=True)
class LeafStats:
    """Precomputed numerics of one quantized leaf: joint hull of ``W`` and
    ``W_hat``, max-abs / mean-square quantization error, signal power."""

    lo: float
    hi: float
    err: float
    err2: float
    ms: float


def _leaf_stats(w: torch.Tensor, wq: torch.Tensor) -> LeafStats:
    """:class:`LeafStats` of one float leaf and its dequantized twin, in
    float64 on the leaf's device, a leading slice at a time."""
    w, wq = w.detach(), wq.detach().to(w.device)
    parts = zip(w.unbind(0), wq.unbind(0)) if w.dim() >= 3 else [(w, wq)]
    lo, hi, err, sq_err, sq_w = 0.0, 0.0, 0.0, 0.0, 0.0
    for a, b in parts:
        a, b = a.to(torch.float64), b.to(torch.float64)
        d = b - a
        vals = torch.stack([a.min(), b.min(), a.max(), b.max(), d.abs().max(),
                            (d * d).sum(), (a * a).sum()]).tolist()
        lo, hi = min(lo, vals[0], vals[1]), max(hi, vals[2], vals[3])
        err, sq_err, sq_w = max(err, vals[4]), sq_err + vals[5], sq_w + vals[6]
    n = max(w.numel(), 1)
    return LeafStats(lo=lo, hi=hi, err=err, err2=sq_err / n, ms=sq_w / n)


def leaf_stats_from_plan(plan, ref_params) -> dict:
    """Per-entry :class:`LeafStats` for an ``ExecutionPlan``, against the
    original float leaves in ``ref_params``.  The hull includes 0 so a
    padded-K decode (zero-filled tail) stays inside it.  Float64 on the
    leaves' device (the reference's numpy float64 arithmetic, a layer of a
    stacked leaf at a time)."""
    from repro_torch.core.apply import _named_leaves
    named = dict(_named_leaves(ref_params))
    return {name: _leaf_stats(named[name], entry.dequantized())
            for name, entry in plan.entries.items()}


def per_tensor_bound(entry, ref_leaf) -> float:
    """Unit-input local output-error bound for one plan entry:
    ``max_n sum_k |W_hat - W|[k, n]`` — the worst-case error of
    ``x @ W_hat`` vs ``x @ W`` over ``|x|_inf <= 1``."""
    d = np.abs(_f64(entry.dequantized()) - _f64(ref_leaf))
    k_axis = max(0, d.ndim - 2)      # leaf layout is (..., K, N)
    return float(d.sum(axis=k_axis).max())


# ---------------------------------------------------------------------------
# abstract values


def _xmul(a: float, b: float) -> float:
    """inf-safe product: 0 * inf -> 0 (a zero interval/error annihilates
    an unbounded factor because actual values are finite)."""
    if a == 0.0 or b == 0.0:
        return 0.0
    return a * b


def _bounds_mul(alo, ahi, blo, bhi):
    ps = (_xmul(alo, blo), _xmul(alo, bhi), _xmul(ahi, blo), _xmul(ahi, bhi))
    return min(ps), max(ps)


def _esum(*dicts) -> dict:
    out: dict = {}
    for d in dicts:
        for t, v in d.items():
            out[t] = out.get(t, 0.0) + v
    return out


def _emax(*dicts) -> dict:
    out: dict = {}
    for d in dicts:
        for t, v in d.items():
            out[t] = max(out.get(t, 0.0), v)
    return out


def _escale(d: dict, k: float) -> dict:
    return {t: _xmul(v, k) for t, v in d.items()}


@dataclasses.dataclass
class ErrVal:
    """Abstract value: joint interval, per-tag sound error, estimate
    channels, and optional payload marker / exact const (a tensor)."""

    lo: float = -INF
    hi: float = INF
    err: dict = dataclasses.field(default_factory=dict)
    ms: float = 0.0
    err2: dict = dataclasses.field(default_factory=dict)
    payload: Optional[frozenset] = None
    const: Optional[torch.Tensor] = None

    @property
    def width(self) -> float:
        return self.hi - self.lo

    @property
    def mag(self) -> float:
        return max(abs(self.lo), abs(self.hi))

    def total_err(self) -> float:
        return min(sum(self.err.values()), self.width) if self.err else 0.0

    def exact(self) -> bool:
        return not any(v > 0.0 for v in self.err.values())


def _cap(ev: ErrVal) -> ErrVal:
    """Clamp each per-tag error at the joint interval width (sound: both
    the fp and the variant value live inside ``[lo, hi]``).  The ``err2``
    estimate channel is capped at width^2 — a saturation model: a
    deviation's power cannot exceed the square of the range it lives in.
    Consequence: ``err2`` propagation is linear only while seeds stay
    small against the intervals they flow through (the regime real
    quantization noise occupies); :func:`output_gains`'s unit seeds
    deliberately saturate at the leaf, yielding range-aware gains."""
    w = ev.hi - ev.lo
    if math.isfinite(w):
        ev.err = {t: min(v, w) for t, v in ev.err.items() if v > 0.0}
        w2 = w * w
        ev.err2 = {t: min(v, w2) for t, v in ev.err2.items() if v > 0.0}
    return ev


def _from_array(x) -> ErrVal:
    """Exact value of a concrete array: float64 statistics on its device."""
    t = x.detach() if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))
    if t.numel() == 0:
        return ErrVal(lo=0.0, hi=0.0, ms=0.0, const=t)
    af = t.to(torch.float64)
    lo, hi, ms = torch.stack([af.min(), af.max(), (af * af).mean()]).tolist()
    return ErrVal(lo=lo, hi=hi, ms=ms,
                  const=t.clone() if t.numel() <= _CONST_SIZE_LIMIT else None)


def _from_stats(s: LeafStats, tag: str) -> ErrVal:
    return ErrVal(lo=s.lo, hi=s.hi, err={tag: s.err} if s.err else {},
                  ms=s.ms, err2={tag: s.err2} if s.err2 else {})


def _top(tags) -> ErrVal:
    tags = set(tags)
    return ErrVal(err={t: INF for t in tags}, err2={t: INF for t in tags})


def _join_vals(vals) -> ErrVal:
    vals = [v for v in vals if v is not None]
    if not vals:
        return ErrVal(lo=0.0, hi=0.0)
    if all(v.payload is not None for v in vals):
        return ErrVal(payload=frozenset().union(*(v.payload for v in vals)))
    consts = [v.const for v in vals]
    const = None
    if all(c is not None for c in consts) and all(v.exact() for v in vals):
        try:
            stacked = torch.stack([c.to(consts[0].device) for c in consts])
            if stacked.numel() <= _CONST_SIZE_LIMIT:
                const = stacked
        except RuntimeError:
            const = None
    return _cap(ErrVal(
        lo=min(v.lo for v in vals), hi=max(v.hi for v in vals),
        err=_emax(*(v.err for v in vals)),
        ms=sum(v.ms for v in vals) / len(vals),
        err2=_emax(*(v.err2 for v in vals)),
        const=const))


# ---------------------------------------------------------------------------
# program values and equations
#
# An atom is a ``torch.Tensor`` the run made or was handed, a ``_Var`` (a
# value of the reference's program that the eager run never materializes:
# an intermediate of an op lowered to several equations) or a ``_Lit`` (a
# Python scalar operand, as the reference's literals).


class _Var:
    __slots__ = ("shape", "dtype", "real")

    def __init__(self, shape, dtype, real=None):
        self.shape, self.dtype, self.real = tuple(shape), dtype, real


class _Lit:
    __slots__ = ("val",)

    def __init__(self, val: torch.Tensor):
        self.val = val


@dataclasses.dataclass(eq=False)
class _Eqn:
    """One equation of the reference's program: ``prim`` names the
    reference's primitive, ``invars`` / ``outvars`` are atoms."""

    prim: str
    invars: list
    outvars: list
    params: dict = dataclasses.field(default_factory=dict)


def _shape(atom) -> tuple:
    if isinstance(atom, _Lit):
        return ()
    return tuple(atom.shape)


def _dtype(atom):
    return atom.val.dtype if isinstance(atom, _Lit) else atom.dtype


def _is_literal(atom) -> bool:
    return isinstance(atom, _Lit)


def _is_float_atom(atom) -> bool:
    return _dtype(atom).is_floating_point


def _numel(shape) -> int:
    return int(math.prod(shape))


def _skey(t: torch.Tensor):
    st = t.untyped_storage()
    return None if st.nbytes() == 0 else (t.device, st.data_ptr())


def _covers(t: torch.Tensor) -> bool:
    """``t`` is its whole storage."""
    return (t.storage_offset() == 0 and t.is_contiguous()
            and t.numel() * t.element_size() == t.untyped_storage().nbytes())


def _whole(t: torch.Tensor) -> torch.Tensor:
    """The whole storage of ``t`` as a flat tensor of its dtype."""
    if _covers(t):
        return t
    n = t.untyped_storage().nbytes() // t.element_size()
    return t.as_strided((n,), (1,), 0)


# ---------------------------------------------------------------------------
# context and generic walk machinery


@dataclasses.dataclass
class _FlashState:
    m: object          # the running max that goes with this ``l``
    m0_hi: float       # the chain's initial max (its upper end)


@dataclasses.dataclass
class _Ctx:
    stats: dict
    report: Report
    location: str
    seeds: dict = dataclasses.field(default_factory=dict)
    vals: dict = dataclasses.field(default_factory=dict)    # storage -> ErrVal
    venv: dict = dataclasses.field(default_factory=dict)    # id(_Var) -> ErrVal
    defs: dict = dataclasses.field(default_factory=dict)    # id(atom) -> _Eqn
    held: list = dataclasses.field(default_factory=list)
    view_cache: dict = dataclasses.field(default_factory=dict)
    unsupported: set = dataclasses.field(default_factory=set)
    flash: dict = dataclasses.field(default_factory=dict)   # id(l) -> _FlashState
    counts: collections.Counter = dataclasses.field(default_factory=collections.Counter)
    escaped: set = dataclasses.field(default_factory=set)
    split_views: dict = dataclasses.field(default_factory=dict)  # id(view) -> ErrVal
    in_kernel: int = 0
    rms_hit: bool = False

    def note_unsupported(self, prim: str, why: str) -> None:
        if prim not in self.unsupported:
            self.unsupported.add(prim)
            self.report.add("info", "numerics/unsupported-op",
                            f"{self.location}: {prim}", why)

    # -- values by storage ------------------------------------------------
    def read_tensor(self, t: torch.Tensor) -> ErrVal:
        split = self.split_views.get(id(t))
        if split is not None:
            return split
        key = _skey(t)
        if key is None:
            return _from_array(t)
        ev = self.vals.get(key)
        if ev is None:           # a tensor the run did not make: a constant
            self.held.append(t)
            ev = self.vals[key] = _from_array(_whole(t))
        if ev.payload is not None or ev.const is None or not ev.exact() \
                or _covers(t):
            return ev
        vk = (t.storage_offset(), tuple(t.shape), tuple(t.stride()), t.dtype)
        per = self.view_cache.setdefault(key, {})
        if vk not in per:        # its own elements (``_slice_lead``)
            out = _from_array(t)
            out.err2 = dict(ev.err2)
            per[vk] = out
        return per[vk]

    def write_tensor(self, t: torch.Tensor, ev: ErrVal, eqn=None) -> None:
        key = _skey(t)
        self.held.append(t)
        if eqn is not None:
            self.defs[id(t)] = eqn
        if key is None:
            return
        self.vals[key] = ev
        self.view_cache.pop(key, None)

    def write_partial(self, t: torch.Tensor, ev: ErrVal, eqn=None) -> None:
        """An in-place write into ``t``: its storage takes the value, or,
        when ``t`` is a part of it, joins it (``dynamic_update_slice``)."""
        key = _skey(t)
        old = self.vals.get(key) if key is not None else None
        if old is None or _covers(t):
            self.write_tensor(t, ev, eqn)
            return
        joined = _join_vals([old, ev])
        joined.const = None
        self.write_tensor(t, joined)

    def seed(self, t: torch.Tensor, ev: ErrVal) -> None:
        self.write_tensor(t, ev)


def _read(ctx: _Ctx, atom) -> ErrVal:
    if isinstance(atom, _Lit):
        return _from_array(atom.val)
    if isinstance(atom, _Var):
        ev = ctx.venv.get(id(atom))
        return ErrVal() if ev is None else ev
    return ctx.read_tensor(atom)


def _write(ctx: _Ctx, atom, ev: ErrVal) -> None:
    if isinstance(atom, _Var):
        ctx.venv[id(atom)] = ev
    else:
        ctx.write_tensor(atom, ev)


def _strip(ctx: _Ctx, atom):
    """Strip shape-only pass-through eqns; returns the defining core atom."""
    for _ in range(128):
        if _is_literal(atom):
            return atom
        eqn = ctx.defs.get(id(atom))
        if eqn is None or eqn.prim not in _PASS_THROUGH:
            return atom
        atom = eqn.invars[0]
    return atom


def _def_of(ctx: _Ctx, atom, prim: str):
    """The defining eqn of ``atom`` (after stripping) if its primitive is
    ``prim``, else None."""
    core = _strip(ctx, atom)
    if _is_literal(core):
        return None
    eqn = ctx.defs.get(id(core))
    if eqn is not None and eqn.prim == prim:
        return eqn
    return None


# --- group-max dominance (refinements R1/R2) -------------------------------


def _chain_dim_map(ctx: _Ctx, atom):
    """Walk ``atom`` backward through broadcast/reshape-style eqns.
    Returns ``(core_atom, dim_map)`` where ``dim_map`` maps each dim of
    ``core`` to the dim of the original ``atom`` it is faithfully copied
    to (broadcast dims are dropped)."""
    if _is_literal(atom):
        return atom, {}
    m = {d: d for d in range(len(_shape(atom)))}
    for _ in range(64):
        if _is_literal(atom):
            return atom, m
        eqn = ctx.defs.get(id(atom))
        if eqn is None:
            return atom, m
        p = eqn.prim
        if p == "broadcast_in_dim":
            bd = eqn.params["broadcast_dimensions"]
            inp = eqn.invars[0]
            if _is_literal(inp):
                return inp, {}
            new_m = {}
            out_shape = _shape(eqn.outvars[0])
            for j, outd in enumerate(bd):
                if outd in m and _shape(inp)[j] == out_shape[outd]:
                    new_m[j] = m[outd]
            m, atom = new_m, inp
        elif p in ("convert_element_type", "copy", "stop_gradient"):
            atom = eqn.invars[0]
        elif p in ("reshape", "squeeze", "expand_dims"):
            inp = eqn.invars[0]
            if _is_literal(inp):
                return inp, {}
            out_shape = _shape(eqn.outvars[0])
            in_shape = _shape(inp)
            nz_out = [d for d, s in enumerate(out_shape) if s != 1]
            nz_in = [d for d, s in enumerate(in_shape) if s != 1]
            if ([out_shape[d] for d in nz_out]
                    != [in_shape[d] for d in nz_in]):
                return atom, m    # a genuine reshape: stop here
            new_m = {}
            for di, do in zip(nz_in, nz_out):
                if do in m:
                    new_m[di] = m[do]
            m, atom = new_m, inp
        else:
            return atom, m
    return atom, m


def _group_covers(a_var, dim_map, axes) -> bool:
    """True when a reduce over ``axes`` of ``a``, re-broadcast along
    ``dim_map``, puts each element of ``a`` inside its own group."""
    a_shape = _shape(a_var)
    red_rank = len(a_shape) - len(axes)
    kept = [d for d in range(len(a_shape)) if d not in axes]
    if red_rank < 0:
        return False
    for j, d in enumerate(kept):
        if a_shape[d] == 1:
            continue
        if dim_map.get(j) is None:
            return False
        # dim_map maps reduce-output dim j to a dim of the broadcast
        # result; with rank-aligned elementwise ops that dim must be d.
        if dim_map[j] != d:
            return False
    return True


def _dominating_group_max(ctx: _Ctx, b_atom, a_atom,
                          require_plain: bool = False):
    """Check ``b >= a`` element-wise because ``b`` is (a broadcast of)
    ``max(other, reduce_max(a, axes))``, ``reduce_max(a, axes)`` itself, or
    ``max(..., a, ...)``.  Returns the reduce axes tuple (or ``()`` for the
    direct-operand case), or ``None`` if no proof."""
    a_res = a_atom
    core, dim_map = _chain_dim_map(ctx, b_atom)
    if _is_literal(core):
        return None
    eqn = ctx.defs.get(id(core))
    if eqn is None:
        return None
    candidates = []
    if eqn.prim == "reduce_max":
        candidates.append((eqn, dim_map))
    elif eqn.prim == "max" and not require_plain:
        for op in eqn.invars:
            if op is a_res and not dim_map_broadcasts(
                    core, dim_map):
                return ()
            rm = _def_of(ctx, op, "reduce_max")
            if rm is not None:
                candidates.append((rm, dim_map))
    for rm, dm in candidates:
        if rm.invars[0] is not a_res:
            continue
        axes = tuple(rm.params["axes"])
        if _group_covers(a_res, dm, axes):
            return axes
    return None


def dim_map_broadcasts(core_var, dim_map) -> bool:
    """True if the chain from ``core_var`` broadcasts any non-unit dim."""
    shape = _shape(core_var)
    return any(s != 1 and dim_map.get(d) != d for d, s in enumerate(shape))


# --- rms-norm refinement (R4) ----------------------------------------------


def _scalar_const(ctx: _Ctx, atom) -> Optional[float]:
    ev = _read(ctx, atom)
    if ev.const is not None and ev.exact() and ev.const.numel() == 1:
        return float(ev.const.reshape(()))
    return None


def _same(ctx: _Ctx, a, b, depth: int = 3) -> bool:
    """``a`` is ``b``, or both come out of the same op on the same inputs
    (the port's non-parametric LayerNorm computes ``x - mu`` twice)."""
    a, b = a, b
    if a is b:
        return True
    if depth == 0 or _is_literal(a) or _is_literal(b):
        if _is_literal(a) and _is_literal(b):
            return bool(torch.equal(a.val, b.val))
        return False
    ea, eb = ctx.defs.get(id(a)), ctx.defs.get(id(b))
    if ea is None or eb is None or ea.prim != eb.prim or ea.params != eb.params \
            or len(ea.invars) != len(eb.invars) or ea.prim == "dot_general":
        return False
    return all(_same(ctx, u, v, depth - 1) for u, v in zip(ea.invars, eb.invars))


def _match_rms(ctx: _Ctx, x_atom, r_atom) -> Optional[float]:
    """Match ``r = rsqrt(mean_G(x^2)/n + eps)`` (broadcast back over the
    reduced group); returns ``sqrt(n)`` — the element-wise bound of
    ``x * r`` — or None."""
    rs = _def_of(ctx, r_atom, "rsqrt")
    if rs is None:
        return None
    add = _def_of(ctx, rs.invars[0], "add")
    if add is None:
        return None
    eps = None
    mean_atom = None
    for u, v in ((add.invars[0], add.invars[1]),
                 (add.invars[1], add.invars[0])):
        c = _scalar_const(ctx, v)
        if c is not None and c > 0.0:
            eps, mean_atom = c, u
            break
    if eps is None:
        return None
    n = None
    core = None
    dv = _def_of(ctx, mean_atom, "div")
    if dv is not None:
        c = _scalar_const(ctx, dv.invars[1])
        if c is not None and c > 0.0:
            n, core = c, dv.invars[0]
    if n is None:
        ml = _def_of(ctx, mean_atom, "mul")
        if ml is not None:
            for u, v in ((ml.invars[0], ml.invars[1]),
                         (ml.invars[1], ml.invars[0])):
                c = _scalar_const(ctx, v)
                if c is not None and c > 0.0:
                    n, core = 1.0 / c, u
                    break
    if n is None:
        return None
    _, dim_map = _chain_dim_map(ctx, core)
    rsum = _def_of(ctx, core, "reduce_sum")
    if rsum is None:
        return None
    axes = tuple(rsum.params["axes"])
    sq_atom = rsum.invars[0]
    sq = _def_of(ctx, sq_atom, "square")
    x2 = None
    if sq is not None:
        x2 = sq.invars[0]
    else:
        ip = _def_of(ctx, sq_atom, "integer_pow")
        if ip is not None and ip.params.get("y") == 2:
            x2 = ip.invars[0]
        else:
            ml = _def_of(ctx, sq_atom, "mul")
            if ml is not None and _same(ctx, ml.invars[0], ml.invars[1]):
                x2 = ml.invars[0]
    if x2 is None or not _same(ctx, x2, x_atom):
        return None
    x_res = x_atom
    if _is_literal(x_res) or not _group_covers(x_res, dim_map, axes):
        return None
    return math.sqrt(n)


# ---------------------------------------------------------------------------
# flash-normalizer (online softmax) verification (R3)
#
# The reference matches the carry of a ``lax.scan`` whose body runs a
# 2-branch ``cond``.  ``_chunked_causal`` of the port unrolls the loop in
# Python, so the same carry algebra is matched update by update:
#
#   m_new = max(m, reduce_max(x))   corr = exp(m - m_new)
#   l_new = l * corr + reduce_sum(exp(x - m_new))
#
# where ``l`` / ``m`` are the exact all-zero / exact initial constants of a
# chain (``m0 <= every score's lower bound``) or the outputs of a matched
# update with the same ``m``.  Every matched ``l_new`` is >= 1; the
# reference's scan refines its final carry only, so the bound is applied to
# every read of ``l_new`` except the next update's ``l * corr``.


def _flash_update(ctx: _Ctx, eqn):
    """``None`` if ``eqn`` (an add) is no online-softmax update; ``False``
    if it looks like one but its algebra does not match; else ``(l_in,
    m_in, m_new, x)``."""
    candidate = False
    for rs_atom, mul_atom in ((eqn.invars[0], eqn.invars[1]),
                              (eqn.invars[1], eqn.invars[0])):
        rsum = _def_of(ctx, rs_atom, "reduce_sum")
        mul = _def_of(ctx, mul_atom, "mul")
        if rsum is None or mul is None:
            continue
        pexp = _def_of(ctx, rsum.invars[0], "exp")
        if pexp is None:
            continue
        candidate = True
        axes = tuple(rsum.params["axes"])
        psub = _def_of(ctx, pexp.invars[0], "sub")
        if psub is None or _is_literal(psub.invars[0]):
            continue
        x = psub.invars[0]
        m_new, dim_map = _chain_dim_map(ctx, psub.invars[1])
        mx = None if _is_literal(m_new) else ctx.defs.get(id(m_new))
        if mx is None or mx.prim != "max" or not _group_covers(x, dim_map, axes):
            continue
        for l_in, corr in ((mul.invars[0], mul.invars[1]),
                           (mul.invars[1], mul.invars[0])):
            cexp = _def_of(ctx, corr, "exp")
            csub = None if cexp is None else _def_of(ctx, cexp.invars[0], "sub")
            if csub is None or _strip(ctx, csub.invars[1]) is not m_new:
                continue
            m_in = csub.invars[0]
            for u, v in ((mx.invars[0], mx.invars[1]), (mx.invars[1], mx.invars[0])):
                rmax = _def_of(ctx, v, "reduce_max")
                if (u is m_in and rmax is not None
                        and _strip(ctx, rmax.invars[0]) is _strip(ctx, x)
                        and tuple(rmax.params["axes"]) == axes):
                    return l_in, m_in, m_new, x
    return False if candidate else None


def _flash_note(ctx: _Ctx, eqn) -> None:
    """Record a matched update's ``l_new`` (or count a miss)."""
    hit = _flash_update(ctx, eqn)
    if hit is None:
        return
    if hit is not False:
        l_in, m_in, m_new, x = hit
        lv, mv, xv = _read(ctx, l_in), _read(ctx, m_in), _read(ctx, x)
        state = ctx.flash.get(id(l_in))
        if state is not None and state.m is m_in:
            m0_hi = state.m0_hi
        elif (lv.const is not None and lv.exact() and not bool(torch.any(lv.const))
              and mv.const is not None and mv.exact()):
            m0_hi = float(mv.const.to(torch.float64).max())
        else:
            m0_hi = None
        if m0_hi is not None and m0_hi <= xv.lo:
            ctx.flash[id(eqn.outvars[0])] = _FlashState(m_new, m0_hi)
            ctx.counts["flash_match"] += 1
            return
    ctx.counts["flash_miss"] += 1


def _flash_refine(ctx: _Ctx, eqn, ins: list) -> list:
    """A proven ``l`` reads as ``[max(lo, 1), hi]`` everywhere but in the
    next update's ``l * corr``."""
    for i, atom in enumerate(eqn.invars):
        state = ctx.flash.get(id(atom))
        if state is None:
            continue
        if eqn.prim == "mul" and len(eqn.invars) == 2:
            other = eqn.invars[1 - i]
            cexp = _def_of(ctx, other, "exp")
            csub = None if cexp is None else _def_of(ctx, cexp.invars[0], "sub")
            if csub is not None and csub.invars[0] is state.m:
                continue
        ins[i] = dataclasses.replace(ins[i], lo=max(ins[i].lo, 1.0), const=None)
    return ins


# ---------------------------------------------------------------------------
# transfer rules


def _unary_lipschitz(ev: ErrVal, lo: float, hi: float, lip: float,
                     ms: Optional[float] = None) -> ErrVal:
    if ms is None:
        ms = ((abs(lo) + abs(hi)) / 2.0) ** 2 if math.isfinite(
            lo) and math.isfinite(hi) else INF
    return ErrVal(lo=lo, hi=hi, err=_escale(ev.err, lip), ms=ms,
                  err2=_escale(ev.err2, lip * lip))


def _exp_hi(x: float) -> float:
    return INF if x >= _EXP_CLAMP else math.exp(x)


def _rule_add(ctx, eqn, ins):
    a, b = ins
    if eqn.prim == "sub":
        lo, hi = a.lo - b.hi, a.hi - b.lo
        dom = _dominating_group_max(ctx, eqn.invars[1], eqn.invars[0])
        if dom is not None:
            hi = min(hi, 0.0)
    else:
        lo, hi = a.lo + b.lo, a.hi + b.hi
    return ErrVal(lo=lo, hi=hi, err=_esum(a.err, b.err), ms=a.ms + b.ms,
                  err2=_esum(a.err2, b.err2))


def _rule_mul(ctx, eqn, ins):
    a, b = ins
    lo, hi = _bounds_mul(a.lo, a.hi, b.lo, b.hi)
    err = _esum(_escale(b.err, a.mag), _escale(a.err, b.mag))
    err2 = _esum(_escale(b.err2, a.ms), _escale(a.err2, b.ms))
    out = ErrVal(lo=lo, hi=hi, err=err, ms=a.ms * b.ms, err2=err2)
    for x_atom, r_atom, x_ev in ((eqn.invars[0], eqn.invars[1], a),
                                 (eqn.invars[1], eqn.invars[0], b)):
        bound = _match_rms(ctx, x_atom, r_atom)
        if bound is not None:
            ctx.rms_hit = True
            out.lo, out.hi = max(out.lo, -bound), min(out.hi, bound)
            out.ms = min(out.ms, 1.0) if out.ms else 1.0
            denom = max(x_ev.ms, 1e-12)
            out.err2 = {t: min(v, x_ev.err2.get(t, INF) / denom)
                        for t, v in out.err2.items()}
            break
    return out


def _rule_div(ctx, eqn, ins):
    a, b = ins
    if b.lo <= 0.0 <= b.hi:
        ctx.report.add("info", "numerics/unbounded",
                       f"{ctx.location}: div",
                       "denominator interval spans zero; the static bound "
                       "is unbounded from this point on")
        return _top(set(a.err) | set(b.err))
    bmin = min(abs(b.lo), abs(b.hi))
    qs = [a.lo / b.lo, a.lo / b.hi, a.hi / b.lo, a.hi / b.hi]
    err = _esum(_escale(a.err, 1.0 / bmin),
                _escale(b.err, a.mag / (bmin * bmin)))
    bms = max(b.ms, 1e-30)
    err2 = _esum(_escale(a.err2, 1.0 / bms),
                 _escale(b.err2, a.ms / (bms * bms)))
    return ErrVal(lo=min(qs), hi=max(qs), err=err, ms=a.ms / bms, err2=err2)


def _contraction_size(eqn) -> int:
    """The contraction length K the lowering recorded (the product of the
    contracted dims of ``mm`` / ``bmm`` / a kernel call's ``x``)."""
    return int(eqn.params["k"])


def _rule_dot(ctx, eqn, ins):
    a, b = ins
    k = _contraction_size(eqn)
    plo, phi = _bounds_mul(a.lo, a.hi, b.lo, b.hi)
    err = _escale(_esum(_escale(b.err, a.mag), _escale(a.err, b.mag)),
                  float(k))
    err2 = _escale(_esum(_escale(b.err2, a.ms), _escale(a.err2, b.ms)),
                   float(k))
    return ErrVal(lo=_xmul(k, plo), hi=_xmul(k, phi), err=err,
                  ms=_xmul(k, a.ms * b.ms), err2=err2)


def _reduced_count(eqn) -> int:
    shape = _shape(eqn.invars[0])
    axes = eqn.params["axes"]
    return int(np.prod([shape[d] for d in axes])) if axes else 1


def _rule_reduce_sum(ctx, eqn, ins):
    (a,) = ins
    n = _reduced_count(eqn)
    out = ErrVal(lo=_xmul(n, a.lo), hi=_xmul(n, a.hi),
                 err=_escale(a.err, float(n)), ms=_xmul(n, a.ms),
                 err2=_escale(a.err2, float(n)))
    # softmax denominator: sum(exp(x - group_max(x))) >= exp(0) = 1
    ex = _def_of(ctx, eqn.invars[0], "exp")
    if ex is not None:
        sb = _def_of(ctx, ex.invars[0], "sub")
        if sb is not None:
            axes = _dominating_group_max(ctx, sb.invars[1], sb.invars[0],
                                         require_plain=True)
            if axes is not None and tuple(axes) == tuple(
                    eqn.params["axes"]):
                out.lo = max(out.lo, 1.0)
    return out


def _rule_reduce_minmax(ctx, eqn, ins):
    (a,) = ins
    return ErrVal(lo=a.lo, hi=a.hi, err=dict(a.err), ms=a.ms,
                  err2=dict(a.err2))


def _rule_cumsum(ctx, eqn, ins):
    (a,) = ins
    n = _shape(eqn.invars[0])[eqn.params.get("axis", 0)]
    return ErrVal(lo=min(a.lo, _xmul(n, a.lo)), hi=max(a.hi, _xmul(n, a.hi)),
                  err=_escale(a.err, float(n)), ms=_xmul(n, a.ms),
                  err2=_escale(a.err2, float(n)))


def _rule_exp(ctx, eqn, ins):
    (a,) = ins
    hi = _exp_hi(a.hi)
    lo = 0.0 if a.lo == -INF else _exp_hi(a.lo)
    return _unary_lipschitz(a, lo, hi, hi)


def _rule_elementwise_minmax(ctx, eqn, ins):
    a, b = ins
    if eqn.prim == "max":
        lo, hi = max(a.lo, b.lo), max(a.hi, b.hi)
    else:
        lo, hi = min(a.lo, b.lo), min(a.hi, b.hi)
    return ErrVal(lo=lo, hi=hi, err=_emax(a.err, b.err),
                  ms=max(a.ms, b.ms), err2=_emax(a.err2, b.err2))


def _rule_select(ctx, eqn, ins):
    pred, cases = ins[0], ins[1:]
    if pred.const is not None and pred.exact():
        vals = torch.unique(pred.const.to(torch.int64)).tolist()
        if len(vals) == 1 and 0 <= int(vals[0]) < len(cases):
            c = cases[int(vals[0])]
            return ErrVal(lo=c.lo, hi=c.hi, err=dict(c.err), ms=c.ms,
                          err2=dict(c.err2), const=c.const)
        picked = [cases[int(v)] for v in vals if 0 <= int(v) < len(cases)]
        out = _join_vals(picked or list(cases))
        out.const = None
        return out
    out = _join_vals(list(cases))
    out.const = None
    if not pred.exact():
        w = out.width
        for t, v in pred.err.items():
            if v > 0.0:
                out.err[t] = out.err.get(t, 0.0) + w
                out.err2[t] = out.err2.get(t, 0.0) + (
                    w * w if math.isfinite(w) else INF)
    return out


def _rule_compare(ctx, eqn, ins):
    err = {}
    err2 = {}
    for ev in ins:
        for t, v in ev.err.items():
            if v > 0.0:
                err[t] = 1.0
                err2[t] = 1.0
    return ErrVal(lo=0.0, hi=1.0, err=err, ms=0.5, err2=err2)


def _rule_pass(ctx, eqn, ins):
    a = ins[0]
    return ErrVal(lo=a.lo, hi=a.hi, err=dict(a.err), ms=a.ms,
                  err2=dict(a.err2))


def _rule_gather(ctx, eqn, ins):
    a = ins[0]
    # fill-mode gathers may introduce zeros: widen the hull to include 0
    return ErrVal(lo=min(a.lo, 0.0), hi=max(a.hi, 0.0), err=dict(a.err),
                  ms=a.ms, err2=dict(a.err2))


def _rule_join(ctx, eqn, ins):
    out = _join_vals([ev for ev in ins
                      if getattr(ev, "payload", None) is None])
    out.const = None
    return out


def _rule_pad(ctx, eqn, ins):
    return _join_vals(ins[:2])


def _rule_iota(ctx, eqn, ins):
    n = _shape(eqn.outvars[0])[eqn.params["dimension"]]
    return ErrVal(lo=0.0, hi=float(max(0, n - 1)), ms=(n - 1) ** 2 / 3.0)


def _rule_square(ctx, eqn, ins):
    (a,) = ins
    cands = [a.lo * a.lo, a.hi * a.hi]
    lo = 0.0 if a.lo <= 0.0 <= a.hi else min(cands)
    lip = 2.0 * a.mag
    return _unary_lipschitz(a, lo, max(cands), lip,
                            ms=_xmul(a.ms, a.mag * a.mag))


def _rule_integer_pow(ctx, eqn, ins):
    (a,) = ins
    y = eqn.params["y"]
    if y == 2:
        return _rule_square(ctx, eqn, ins)
    cands = [a.lo ** y, a.hi ** y]
    if y % 2 == 0 and a.lo <= 0.0 <= a.hi:
        lo = 0.0
    elif y % 2 == 1:
        lo = min(cands)
    else:
        lo = min(cands)
    lip = abs(y) * a.mag ** (y - 1) if a.mag != INF else INF
    return _unary_lipschitz(a, lo, max(cands), lip)


def _rule_rsqrt(ctx, eqn, ins):
    (a,) = ins
    if a.lo <= 0.0:
        ctx.report.add("info", "numerics/unbounded",
                       f"{ctx.location}: rsqrt",
                       "rsqrt over an interval touching zero; the static "
                       "bound is unbounded from this point on")
        return _top(set(a.err))
    return _unary_lipschitz(a, 1.0 / math.sqrt(a.hi) if a.hi != INF else 0.0,
                            1.0 / math.sqrt(a.lo), 0.5 * a.lo ** -1.5)


def _rule_sqrt(ctx, eqn, ins):
    (a,) = ins
    lo = math.sqrt(max(a.lo, 0.0))
    hi = math.sqrt(a.hi) if a.hi != INF else INF
    lip = INF if a.lo <= 0.0 else 0.5 / math.sqrt(a.lo)
    return _unary_lipschitz(a, lo, hi, lip)


def _rule_log(ctx, eqn, ins):
    (a,) = ins
    if a.lo <= 0.0:
        return _top(set(a.err))
    return _unary_lipschitz(a, math.log(a.lo),
                            math.log(a.hi) if a.hi != INF else INF,
                            1.0 / a.lo)


def _sigmoid(x: float) -> float:
    if x >= 0:
        return 1.0 / (1.0 + math.exp(-min(x, _EXP_CLAMP)))
    return math.exp(max(x, -_EXP_CLAMP)) / (
        1.0 + math.exp(max(x, -_EXP_CLAMP)))


def _rule_logistic(ctx, eqn, ins):
    (a,) = ins
    return _unary_lipschitz(a, _sigmoid(a.lo), _sigmoid(a.hi), 0.25)


def _rule_tanh(ctx, eqn, ins):
    (a,) = ins
    return _unary_lipschitz(a, max(-1.0, math.tanh(a.lo) if a.lo != -INF
                                   else -1.0),
                            min(1.0, math.tanh(a.hi) if a.hi != INF
                                else 1.0), 1.0)


def _rule_trig(ctx, eqn, ins):
    (a,) = ins
    return _unary_lipschitz(a, -1.0, 1.0, 1.0, ms=0.5)


def _rule_erf(ctx, eqn, ins):
    (a,) = ins
    return _unary_lipschitz(a, -1.0, 1.0, 2.0 / math.sqrt(math.pi))


def _rule_abs(ctx, eqn, ins):
    (a,) = ins
    lo = 0.0 if a.lo <= 0.0 <= a.hi else min(abs(a.lo), abs(a.hi))
    return _unary_lipschitz(a, lo, a.mag, 1.0, ms=a.ms)


def _rule_neg(ctx, eqn, ins):
    (a,) = ins
    return ErrVal(lo=-a.hi, hi=-a.lo, err=dict(a.err), ms=a.ms,
                  err2=dict(a.err2))


def _rule_sign(ctx, eqn, ins):
    (a,) = ins
    err = {t: 2.0 for t, v in a.err.items() if v > 0.0}
    return ErrVal(lo=-1.0, hi=1.0, err=err, ms=1.0,
                  err2={t: 4.0 for t in err})


def _rule_round(ctx, eqn, ins):
    (a,) = ins
    err = {t: v + 1.0 for t, v in a.err.items() if v > 0.0}
    return ErrVal(lo=a.lo - 1.0, hi=a.hi + 1.0, err=err, ms=a.ms + 1.0,
                  err2={t: (v + 1.0) ** 2 if math.isfinite(v) else INF
                        for t, v in a.err2.items()})


def _rule_clamp(ctx, eqn, ins):
    amin, x, amax = ins
    lo = min(max(x.lo, amin.lo), amax.lo)
    hi = min(max(x.hi, amin.hi), amax.hi)
    return ErrVal(lo=lo, hi=hi, err=_esum(amin.err, x.err, amax.err),
                  ms=x.ms, err2=_esum(amin.err2, x.err2, amax.err2))


def _rule_bool(ctx, eqn, ins):
    err = {}
    for ev in ins:
        for t, v in ev.err.items():
            if v > 0.0:
                err[t] = 1.0
    return ErrVal(lo=0.0, hi=1.0, err=err, ms=0.5,
                  err2={t: 1.0 for t in err})


def _rule_int_bitwise(ctx, eqn, ins):
    dt = _dtype(eqn.outvars[0])
    if dt.is_floating_point or dt.is_complex or dt == torch.bool:
        return _top(set().union(*(ev.err for ev in ins)))
    info = torch.iinfo(dt)
    err = {t: INF for ev in ins for t, v in ev.err.items() if v > 0.0}
    return ErrVal(lo=float(info.min), hi=float(info.max), err=err,
                  err2=dict(err))


_RULES = {
    "add": _rule_add, "sub": _rule_add,
    "mul": _rule_mul,
    "div": _rule_div,
    "dot_general": _rule_dot, "conv_general_dilated": _rule_dot,
    "reduce_sum": _rule_reduce_sum,
    "reduce_max": _rule_reduce_minmax, "reduce_min": _rule_reduce_minmax,
    "cumsum": _rule_cumsum,
    "exp": _rule_exp, "exp2": _rule_exp,
    "max": _rule_elementwise_minmax, "min": _rule_elementwise_minmax,
    "select_n": _rule_select,
    "lt": _rule_compare, "le": _rule_compare, "gt": _rule_compare,
    "ge": _rule_compare, "eq": _rule_compare, "ne": _rule_compare,
    "broadcast_in_dim": _rule_pass, "reshape": _rule_pass,
    "transpose": _rule_pass, "squeeze": _rule_pass,
    "expand_dims": _rule_pass, "rev": _rule_pass, "slice": _rule_pass,
    "convert_element_type": _rule_pass, "copy": _rule_pass,
    "stop_gradient": _rule_pass, "dynamic_slice": _rule_pass,
    "real": _rule_pass, "imag": _rule_pass,
    "reduce_precision": _rule_pass,
    "all_gather": _rule_pass, "pmax": _rule_pass, "pmin": _rule_pass,
    "gather": _rule_gather,
    "concatenate": _rule_join, "dynamic_update_slice": _rule_join,
    "scatter": _rule_join,
    "pad": _rule_pad,
    "iota": _rule_iota,
    "square": _rule_square,
    "integer_pow": _rule_integer_pow,
    "rsqrt": _rule_rsqrt, "sqrt": _rule_sqrt,
    "log": _rule_log, "log1p": _rule_log,
    "logistic": _rule_logistic,
    "tanh": _rule_tanh,
    "sin": _rule_trig, "cos": _rule_trig,
    "erf": _rule_erf,
    "abs": _rule_abs,
    "neg": _rule_neg,
    "sign": _rule_sign,
    "floor": _rule_round, "ceil": _rule_round, "round": _rule_round,
    "clamp": _rule_clamp,
    "and": _rule_bool, "or": _rule_bool, "not": _rule_bool,
    "is_finite": _rule_bool, "reduce_and": _rule_bool,
    "reduce_or": _rule_bool,
    "xor": _rule_int_bitwise, "shift_left": _rule_int_bitwise,
    "shift_right_logical": _rule_int_bitwise,
    "shift_right_arithmetic": _rule_int_bitwise,
    "rem": _rule_int_bitwise,
}


def _rule_pow(ctx, eqn, ins):
    a, b = ins
    y = _scalar_const(ctx, eqn.invars[1])
    if y is not None and float(y).is_integer() and abs(y) < 64:
        fake = type("E", (), {"params": {"y": int(y)},
                              "invars": [eqn.invars[0]],
                              "outvars": eqn.outvars})
        return _rule_integer_pow(ctx, fake, [a])
    return _top(set(a.err) | set(b.err))


_RULES["pow"] = _rule_pow


# ---------------------------------------------------------------------------
# the walker


def _in_tags(ins) -> set:
    tags: set = set()
    for ev in ins:
        tags.update(t for t, v in ev.err.items() if v > 0.0)
        if ev.payload is not None:
            tags.update(ev.payload)
    return tags


def _assign_top(ctx: _Ctx, eqn, ins) -> None:
    top = _top(_in_tags(ins))
    for ov in eqn.outvars:
        _write(ctx, ov, top)


def _is_neutral(atom, ev: ErrVal) -> bool:
    """Decode-plumbing operands don't break payload purity: integer/bool
    consts (shift counts, gather indices, bit masks) and uniform-valued
    float consts (fill values, scaling literals).  A non-uniform float
    operand is program data — mixing with it materializes the payload."""
    if ev.const is None or not ev.exact():
        return False
    if not _is_float_atom(atom):
        return True
    c = ev.const
    return c.numel() <= 1 or float(c.min()) == float(c.max())


_EVAL = {
    "broadcast_in_dim": lambda e, x: x.reshape(
        tuple(x.shape[e.params["broadcast_dimensions"].index(d)]
              if d in e.params["broadcast_dimensions"] else 1
              for d in range(len(e.params["shape"])))).expand(e.params["shape"]),
    "convert_element_type": lambda e, x: x.to(e.outvars[0].dtype),
    "copy": lambda e, x: x,
    "reduce_sum": lambda e, x: x.sum(dim=e.params["axes"]),
    "reduce_max": lambda e, x: x.amax(dim=e.params["axes"]),
    "add": lambda e, a, b: a + b, "sub": lambda e, a, b: a - b,
    "mul": lambda e, a, b: a * b, "div": lambda e, a, b: a / b,
    "max": lambda e, a, b: torch.maximum(a, b.to(a.dtype)),
    "min": lambda e, a, b: torch.minimum(a, b.to(a.dtype)),
    "exp": lambda e, x: torch.exp(x), "log": lambda e, x: torch.log(x),
    "logistic": lambda e, x: torch.sigmoid(x), "tanh": lambda e, x: torch.tanh(x),
    "neg": lambda e, x: -x, "floor": lambda e, x: torch.floor(x),
    "round": lambda e, x: torch.round(x),
    "integer_pow": lambda e, x: x ** e.params["y"],
    "erfc": lambda e, x: torch.special.erfc(x),
    "iota": lambda e: torch.arange(e.outvars[0].shape[e.params["dimension"]],
                                   dtype=torch.int32).reshape(
        [-1 if d == e.params["dimension"] else 1
         for d in range(len(e.outvars[0].shape))]).expand(e.outvars[0].shape),
    "ge": lambda e, a, b: a >= b, "ne": lambda e, a, b: a != b,
    "abs": lambda e, x: torch.abs(x), "log1p": lambda e, x: torch.log1p(x),
    "select_n": lambda e, p, *cases: torch.where(p.bool(), cases[1], cases[0]),
}


def _concrete(eqn, ins):
    """The concrete output of an all-const eqn: the run's own tensor for
    the last eqn of an op, else evaluated from the consts."""
    real = eqn.outvars[0].real if isinstance(eqn.outvars[0], _Var) \
        else eqn.outvars[0]
    if real is not None:
        return real
    ev = _EVAL.get(eqn.prim)
    return None if ev is None else ev(eqn, *[x.const for x in ins])


def _try_const(ctx: _Ctx, eqn, ins, out: ErrVal) -> ErrVal:
    if len(eqn.outvars) > 1:
        return out
    if any(ev.const is None or not ev.exact() for ev in ins):
        return out
    if _numel(_shape(eqn.outvars[0])) > _CONST_SIZE_LIMIT:
        return out
    try:
        res = _concrete(eqn, ins)
        if res is None:
            return out
        ev = _from_array(res)
    except (RuntimeError, TypeError, ValueError, IndexError):
        return out
    ev.err, ev.err2 = out.err, out.err2
    return ev


def _eqn(ctx: _Ctx, eqn) -> None:
    prim = eqn.prim
    for ov in eqn.outvars:
        ctx.defs[id(ov)] = eqn
        ctx.held.append(ov)
    ins = _flash_refine(ctx, eqn, [_read(ctx, a) for a in eqn.invars])

    if any(ev.payload is not None for ev in ins):
        mixing = any(ev.payload is None and not _is_neutral(atom, ev)
                     for atom, ev in zip(eqn.invars, ins))
        if not mixing:
            tags = frozenset().union(*(ev.payload for ev in ins
                                       if ev.payload is not None))
            out = ErrVal(payload=tags)
            for ov in eqn.outvars:
                _write(ctx, ov, out)
            return
        new_ins = []
        for atom, ev in zip(eqn.invars, ins):
            if ev.payload is None:
                new_ins.append(ev)
                continue
            tag = next(iter(ev.payload)) if len(ev.payload) == 1 else None
            if (tag is not None and tag in ctx.stats
                    and not _is_literal(atom) and _is_float_atom(atom)):
                new_ins.append(_from_stats(ctx.stats[tag], tag))
            else:
                ctx.note_unsupported(
                    prim, "packed payload mixes with program values "
                    "before decode completes")
                _assign_top(ctx, eqn, ins)
                return
        ins = new_ins

    rule = _RULES.get(prim)
    if rule is None:
        ctx.note_unsupported(
            prim, "no transfer rule; bound is unconstrained downstream")
        _assign_top(ctx, eqn, ins)
        return
    ctx.rms_hit = False
    out = rule(ctx, eqn, ins)
    if prim == "mul" and any(_def_of(ctx, a, "rsqrt") is not None
                             for a in eqn.invars):
        ctx.counts["rms_match" if ctx.rms_hit else "rms_miss"] += 1
    out = _try_const(ctx, eqn, ins, out)
    _cap(out)
    for ov in eqn.outvars:
        _write(ctx, ov, out)
    if prim == "add":
        _flash_note(ctx, eqn)


# ---------------------------------------------------------------------------
# ATen ops -> the reference's equations


class _Lower:
    """Emits the reference's equations for one ATen op of the run."""

    def __init__(self, ctx: _Ctx, name: str, args: dict, outs: list):
        self.ctx, self.name, self.a, self.outs = ctx, name, args, outs

    def emit(self, prim, invars, params=None, shape=None, dtype=None, real=None):
        out = self.outs[0] if self.outs else None
        shape = tuple(real.shape) if real is not None else (
            shape if shape is not None else tuple(out.shape))
        v = _Var(shape, dtype or (real.dtype if real is not None else out.dtype), real)
        _eqn(self.ctx, _Eqn(prim, list(invars), [v], dict(params or {})))
        return v

    def final(self, prim, invars, params=None, i=0):
        """The op's own output ``i``: the last equation of its lowering."""
        return self.emit(prim, invars, params, real=self.outs[i])

    def lit(self, v, like=None) -> _Lit:
        dt = torch.result_type(like, v) if isinstance(like, torch.Tensor) \
            else (self.outs[0].dtype if self.outs else torch.float32)
        if isinstance(v, bool):
            dt = torch.bool
        return _Lit(torch.tensor(v, dtype=dt))

    def atom(self, v, like=None):
        return v if isinstance(v, torch.Tensor) else self.lit(v, like)

    def rank_bc(self, atom, out_shape):
        """jnp's rank promotion: a lower-rank operand gains leading unit
        dims through ``broadcast_in_dim`` (size-1 dims broadcast inside the
        op, scalars stay as they are)."""
        sh = _shape(atom)
        if len(sh) == 0 or len(sh) >= len(out_shape):
            return atom
        r = len(out_shape)
        new = (1,) * (r - len(sh)) + sh
        return self.emit("broadcast_in_dim", [atom],
                         {"shape": new, "broadcast_dimensions": tuple(range(r - len(sh), r))},
                         shape=new, dtype=_dtype(atom))

    def full_bc(self, atom, out_shape):
        """``jnp.where``'s broadcast of every operand to the full shape."""
        sh, out_shape = _shape(atom), tuple(out_shape)
        if sh == out_shape:
            return atom
        r = len(out_shape)
        return self.emit("broadcast_in_dim", [atom],
                         {"shape": out_shape,
                          "broadcast_dimensions": tuple(range(r - len(sh), r))},
                         shape=out_shape, dtype=_dtype(atom))

    def binary(self, prim, x, y, real=True):
        like = x if isinstance(x, torch.Tensor) else y
        x, y = self.atom(x, like), self.atom(y, like)
        shape = tuple(self.outs[0].shape)
        x, y = self.rank_bc(x, shape), self.rank_bc(y, shape)
        return self.final(prim, [x, y]) if real else self.emit(prim, [x, y])

    def reduce(self, prim, x, dims, keepdim, then=None):
        """A reduction over ``dims``; ``keepdim`` re-broadcasts it (jnp's
        ``keepdims``); ``then(var)`` adds the op's last equation."""
        rank = x.dim()
        axes = tuple(range(rank)) if dims is None or (isinstance(dims, (list, tuple))
                                                    and len(dims) == 0) \
            else tuple(sorted(d % max(rank, 1) for d in
                              (dims if isinstance(dims, (list, tuple)) else [dims])))
        red = tuple(s for d, s in enumerate(x.shape) if d not in axes)
        kept = [d for d in range(rank) if d not in axes]
        last = then is None and not keepdim
        v = self.final(prim, [x], {"axes": axes}) if last else \
            self.emit(prim, [x], {"axes": axes}, shape=red, dtype=self.outs[0].dtype)
        if keepdim:
            kshape = tuple(1 if d in axes else s for d, s in enumerate(x.shape))
            params = {"shape": kshape, "broadcast_dimensions": tuple(kept)}
            v = self.final("broadcast_in_dim", [v], params) if then is None else \
                self.emit("broadcast_in_dim", [v], params, shape=kshape,
                          dtype=self.outs[0].dtype)
        return v if then is None else then(v, axes)


def _axes_count(x, axes) -> float:
    return float(math.prod(x.shape[d] for d in axes))


def _lo_add(L, sub: bool, swap: bool = False):
    a = L.a
    x, y = a["self"], a["other"]
    if swap:
        x, y = y, x
    alpha = a.get("alpha", 1)
    if alpha is not None and alpha != 1:
        like = x if isinstance(x, torch.Tensor) else y
        y = L.emit("mul", [L.atom(y, like), L.lit(alpha, like)],
                   shape=_shape(L.atom(y, like)))
    L.binary("sub" if sub else "add", x, y)


def _lo_binary(prim):
    return lambda L: L.binary(prim, L.a["self"], L.a["other"])


def _lo_unary(prim):
    return lambda L: L.final(prim, [L.a["self"]])


def _lo_div(L):
    mode = L.a.get("rounding_mode")
    if mode is None:
        L.binary("div", L.a["self"], L.a["other"])
        return
    v = L.binary("div", L.a["self"], L.a["other"], real=False)
    L.final("floor" if mode == "floor" else "round", [v])


def _lo_pow(L):
    base, ex = L.a["self"], L.a["exponent"]
    if isinstance(base, torch.Tensor) and not isinstance(ex, torch.Tensor) \
            and float(ex).is_integer():
        L.final("integer_pow", [base], {"y": int(ex)})
    else:
        L.binary("pow", base, ex)


def _lo_reciprocal(L):
    x = L.a["self"]
    L.final("div", [L.lit(1.0, x), x])


def _lo_clamp(L):
    a = L.a
    x, lo, hi = a["self"], a.get("min"), a.get("max")
    if lo is not None and hi is not None:
        shape = tuple(L.outs[0].shape)
        L.final("clamp", [L.rank_bc(L.atom(lo, x), shape), x,
                          L.rank_bc(L.atom(hi, x), shape)])
    elif lo is not None:
        L.binary("max", x, lo)
    else:
        L.binary("min", x, hi)


def _lo_reduce(prim):
    return lambda L: L.reduce(prim, L.a["self"], L.a.get("dim"),
                              bool(L.a.get("keepdim", False)))


def _lo_mean(L):
    x = L.a["self"]
    L.reduce("reduce_sum", x, L.a.get("dim"), bool(L.a.get("keepdim", False)),
             then=lambda v, axes: L.final("div", [v, _Lit(torch.tensor(
                 _axes_count(x, axes), dtype=torch.float32))]))


def _lo_max_dim(L):
    """``max.dim`` / ``min.dim``: the values reduce, the indices depend on
    the data."""
    x, dim, keep = L.a["self"], L.a["dim"], bool(L.a.get("keepdim", False))
    prim = "reduce_max" if L.name == "max" else "reduce_min"
    axes = (dim % x.dim(),)
    red = tuple(s for d, s in enumerate(x.shape) if d not in axes)
    if keep:
        v = L.emit(prim, [x], {"axes": axes}, shape=red)
        L.final("broadcast_in_dim", [v], {"shape": tuple(L.outs[0].shape),
                                          "broadcast_dimensions": tuple(
                                              d for d in range(x.dim()) if d not in axes)})
    else:
        L.final(prim, [x], {"axes": axes})
    _data_dependent(L.ctx, L.name, [L.ctx.read_tensor(x)], L.outs[1:])


def _lo_cumsum(L):
    x = L.a["self"]
    L.final("cumsum", [x], {"axis": L.a["dim"] % max(x.dim(), 1)})


def _lo_dot(L):
    a = L.a
    if L.name in ("mm", "bmm"):
        x = a["self"]
        L.final("dot_general", [x, a["mat2"]], {"k": x.shape[-1]})
        return
    # addmm / baddbmm: beta * self + alpha * (x @ w)
    x, w = (a["mat1"], a["mat2"]) if L.name == "addmm" else (a["batch1"], a["batch2"])
    shape = tuple(L.outs[0].shape)
    v = L.emit("dot_general", [x, w], {"k": x.shape[-1]}, shape=shape)
    if a.get("alpha", 1) != 1:
        v = L.emit("mul", [v, L.lit(a["alpha"], x)], shape=shape)
    b = a["self"]
    if a.get("beta", 1) != 1:
        b = L.emit("mul", [b, L.lit(a["beta"], x)], shape=_shape(b))
    L.final("add", [v, L.rank_bc(b, shape)])


def _lo_max_min(L):
    """``max`` / ``min``: over one dim (values and indices), elementwise
    against ``other``, or over everything."""
    if L.a.get("dim") is not None:
        _lo_max_dim(L)
    elif L.a.get("other") is not None:
        L.binary("max" if L.name == "max" else "min", L.a["self"], L.a["other"])
    else:
        L.reduce("reduce_max" if L.name == "max" else "reduce_min", L.a["self"],
                 None, False)


def _lo_where(L):
    a = L.a
    shape = tuple(L.outs[0].shape)
    cond, x, y = a["condition"], a["self"], a["other"]
    like = L.outs[0]
    L.final("select_n", [L.full_bc(cond, shape), L.full_bc(L.atom(y, like), shape),
                         L.full_bc(L.atom(x, like), shape)])


def _lo_masked_fill(L):
    a = L.a
    shape = tuple(L.outs[0].shape)
    x = a["self"]
    L.final("select_n", [L.full_bc(a["mask"], shape), x,
                         L.full_bc(L.atom(a["value"], x), shape)])


def _lo_softmax(L, log: bool):
    """The reference's composition: group max, dominated sub, exp, a
    denominator of at least 1, then the divide (``log``: the log and the
    subtract of ``log_softmax``)."""
    x = L.a["self"]
    axes = (L.a["dim"] % x.dim(),)
    kept = tuple(d for d in range(x.dim()) if d not in axes)
    red = tuple(x.shape[d] for d in kept)
    kshape = tuple(1 if d in axes else s for d, s in enumerate(x.shape))
    bc = {"shape": kshape, "broadcast_dimensions": kept}
    f32 = L.outs[0].dtype
    m = L.emit("reduce_max", [x], {"axes": axes}, shape=red, dtype=f32)
    mb = L.emit("broadcast_in_dim", [m], bc, shape=kshape, dtype=f32)
    s = L.emit("sub", [x, mb], dtype=f32)
    e = L.emit("exp", [s], dtype=f32)
    d = L.emit("reduce_sum", [e], {"axes": axes}, shape=red, dtype=f32)
    db = L.emit("broadcast_in_dim", [d], bc, shape=kshape, dtype=f32)
    if log:
        ld = L.emit("log", [db], shape=kshape, dtype=f32)
        L.final("sub", [s, ld])
    else:
        L.final("div", [e, db])


def _lo_silu(L):
    x = L.a["self"]
    L.final("mul", [x, L.emit("logistic", [x])])


def _lo_gelu(L):
    """``jax.nn.gelu``'s equations (tanh approximation or the erfc form)."""
    x = L.a["self"]
    f = lambda v: _Lit(torch.tensor(v, dtype=x.dtype))  # noqa: E731
    if L.a.get("approximate", "none") == "tanh":
        b = L.emit("integer_pow", [x], {"y": 3})
        c = L.emit("mul", [f(0.044714998453855515), b])
        d = L.emit("add", [x, c])
        e = L.emit("mul", [f(0.7978845834732056), d])
        g = L.emit("add", [f(1.0), L.emit("tanh", [e])])
        L.final("mul", [x, L.emit("mul", [f(0.5), g])])
    else:
        b = L.emit("mul", [f(0.5), x])
        d = L.emit("mul", [L.emit("neg", [x]), f(0.7071067690849304)])
        L.final("copy", [L.emit("mul", [b, L.emit("erfc", [d])])])


def _lo_softplus(L):
    """``jax.nn.softplus``: ``logaddexp(x, 0)``'s equations (``beta`` 1)."""
    x = L.a["self"]
    if L.a.get("beta", 1) != 1:
        _unsupported(L, "softplus with beta != 1")
        return
    z = L.lit(0.0, x)
    e = L.emit("max", [x, z])
    f = L.emit("sub", [x, z])
    g = L.emit("ne", [f, f], dtype=torch.bool)
    h = L.emit("add", [x, z])
    k = L.emit("exp", [L.emit("neg", [L.emit("abs", [f])])])
    m = L.emit("add", [e, L.emit("log1p", [k])])
    L.final("select_n", [g, m, h])


def _lo_tril(L):
    """``jnp.tril``: a mask from two iotas, then ``select_n`` against
    zeros."""
    x, k = L.a["self"], L.a.get("diagonal", 0) or 0
    rc = tuple(x.shape[-2:])
    i = L.emit("iota", [], {"dimension": 0}, shape=rc, dtype=torch.int32)
    i = L.emit("add", [i, _Lit(torch.tensor(k, dtype=torch.int32))], shape=rc,
               dtype=torch.int32)
    j = L.emit("iota", [], {"dimension": 1}, shape=rc, dtype=torch.int32)
    mask = L.emit("ge", [i, j], shape=rc, dtype=torch.bool)
    shape = tuple(x.shape)
    zero = L.full_bc(_Lit(torch.tensor(0, dtype=x.dtype)), shape)
    L.final("select_n", [L.full_bc(mask, shape), zero, x])


def _unsupported(L, why: str) -> None:
    L.ctx.note_unsupported(L.name, why)
    top = _top(_in_tags([L.ctx.read_tensor(t) for t in _tensors_of(L.a)]))
    for o in L.outs:
        _write(L.ctx, o, top)


def _lo_relu(L):
    x = L.a["self"]
    L.final("max", [x, L.lit(0.0, x)])


def _lo_gather(L):
    a = L.a
    if L.name == "embedding":
        src, idx = a["weight"], [a["indices"]]
    elif L.name == "index":
        src, idx = a["self"], [i for i in a["indices"] if i is not None]
        if any(i.dtype == torch.bool for i in idx):
            _masked(L, src, idx)
            return
    else:
        src, idx = a["self"], [a["index"]]
    L.final("gather", [src] + idx)


def _masked(L, src, masks):
    """Boolean-mask selection: its shape depends on the data."""
    ctx = L.ctx
    ins = [ctx.read_tensor(src)] + [ctx.read_tensor(m) for m in masks]
    if all(ev.exact() and ev.payload is None for ev in ins[1:]):
        L.final("gather", [src] + list(masks))
    else:
        _data_dependent(ctx, "masked_select", ins, L.outs)


def _lo_join(L):
    ts = [t for t in L.a["tensors"] if t.numel() or t.dim() > 1]
    L.final("concatenate", ts)


def _lo_pad(L):
    x = L.a["self"]
    L.final("pad", [x, L.lit(L.a.get("value", 0) or 0, x)])


def _lo_update_slice(L):
    """``slice_scatter`` / ``select_scatter``: ``dynamic_update_slice``
    with its start indices."""
    a = L.a
    x, src = a["self"], a["src"]
    dim = a["dim"] % x.dim()
    start = a.get("start", a.get("index")) or 0
    start = start % x.shape[dim] if start < 0 else start
    starts = [_Lit(torch.tensor(start if d == dim else 0, dtype=torch.int64))
              for d in range(x.dim())]
    L.final("dynamic_update_slice", [x, src] + starts)


def _lo_scatter(L):
    a = L.a
    if L.name == "index_put":
        if a.get("accumulate"):
            L.ctx.note_unsupported("index_put(accumulate)", "scatter-add has no "
                                   "transfer rule; bound is unconstrained downstream")
            _assign_top(L.ctx, _Eqn("scatter_add", [], [L.outs[0]]),
                        [L.ctx.read_tensor(a["self"]), L.ctx.read_tensor(a["values"])])
            return
        L.final("scatter", [a["self"]] + [i for i in a["indices"] if i is not None]
                + [L.atom(a["values"], a["self"])])
    else:
        L.final("scatter", [a["self"], a["index"],
                            L.atom(a.get("src", a.get("value")), a["self"])])


def _lo_pass(prim):
    return lambda L: L.final(prim, [L.a["self"]])


def _rule_rng(ctx, eqn, ins):
    """A tensor made from data the program does not compute (random draws,
    a strided ``arange``, which jnp folds into a constant): exact, as
    made."""
    return _from_array(eqn.outvars[0].real)


_RULES["rng"] = _rule_rng


def _lo_const(L):
    """A tensor made from nothing (its inputs give only a shape or a fill
    value): ``broadcast_in_dim`` of the fill literal, or ``iota``."""
    out = L.outs[0]
    if L.name in ("empty", "empty_like", "new_empty", "empty_strided"):
        return                        # no value until something writes it
    if L.name == "arange":
        a = L.a
        plain = (a.get("start", 0) or 0) == 0 and (a.get("step", 1) or 1) == 1
        L.final("iota" if plain else "rng", [], {"dimension": 0} if plain else {})
        return
    fill = {"zeros": 0, "zeros_like": 0, "new_zeros": 0, "ones": 1, "ones_like": 1,
            "new_ones": 1}.get(L.name)
    if fill is None and L.name in ("full", "full_like", "new_full", "scalar_tensor"):
        fill = L.a.get("fill_value", L.a.get("s"))
    if fill is None:
        L.final("rng", [])
        return
    lit = fill if isinstance(fill, torch.Tensor) else \
        _Lit(torch.tensor(fill, dtype=out.dtype))
    L.final("broadcast_in_dim", [lit],
            {"shape": tuple(out.shape), "broadcast_dimensions": ()})


_LOWER = {
    "add": lambda L: _lo_add(L, False), "sub": lambda L: _lo_add(L, True),
    "rsub": lambda L: _lo_add(L, True, swap=True),
    "mul": _lo_binary("mul"), "div": _lo_div,
    "maximum": _lo_binary("max"), "minimum": _lo_binary("min"),
    "fmax": _lo_binary("max"), "fmin": _lo_binary("min"),
    "pow": _lo_pow, "reciprocal": _lo_reciprocal,
    "clamp": _lo_clamp,
    "clamp_min": lambda L: L.binary("max", L.a["self"], L.a["min"]),
    "clamp_max": lambda L: L.binary("min", L.a["self"], L.a["max"]),
    "exp": _lo_unary("exp"), "exp2": _lo_unary("exp2"),
    "log": _lo_unary("log"), "log1p": _lo_unary("log1p"),
    "sqrt": _lo_unary("sqrt"), "rsqrt": _lo_unary("rsqrt"),
    "sigmoid": _lo_unary("logistic"), "tanh": _lo_unary("tanh"),
    "sin": _lo_unary("sin"), "cos": _lo_unary("cos"),
    "erf": _lo_unary("erf"), "erfc": _lo_unary("erfc"),
    "abs": _lo_unary("abs"), "neg": _lo_unary("neg"), "sign": _lo_unary("sign"),
    "round": _lo_unary("round"), "floor": _lo_unary("floor"), "ceil": _lo_unary("ceil"),
    "square": _lo_unary("square"),
    "isfinite": _lo_unary("is_finite"),
    "logical_not": _lo_unary("not"), "bitwise_not": _lo_unary("not"),
    "logical_and": _lo_binary("and"), "bitwise_and": _lo_binary("and"),
    "logical_or": _lo_binary("or"), "bitwise_or": _lo_binary("or"),
    "bitwise_xor": _lo_binary("xor"), "logical_xor": _lo_binary("xor"),
    "__lshift__": _lo_binary("shift_left"),
    "bitwise_left_shift": _lo_binary("shift_left"),
    "__rshift__": _lo_binary("shift_right_arithmetic"),
    "bitwise_right_shift": _lo_binary("shift_right_arithmetic"),
    "remainder": _lo_binary("rem"), "fmod": _lo_binary("rem"),
    "lt": _lo_binary("lt"), "le": _lo_binary("le"), "gt": _lo_binary("gt"),
    "ge": _lo_binary("ge"), "eq": _lo_binary("eq"), "ne": _lo_binary("ne"),
    "where": _lo_where, "masked_fill": _lo_masked_fill,
    "sum": _lo_reduce("reduce_sum"), "mean": _lo_mean,
    "amax": _lo_reduce("reduce_max"), "amin": _lo_reduce("reduce_min"),
    "any": _lo_reduce("reduce_or"), "all": _lo_reduce("reduce_and"),
    "cumsum": _lo_cumsum,
    "max": _lo_max_min, "min": _lo_max_min,
    "mm": _lo_dot, "bmm": _lo_dot, "addmm": _lo_dot, "baddbmm": _lo_dot,
    "_softmax": lambda L: _lo_softmax(L, False),
    "_log_softmax": lambda L: _lo_softmax(L, True),
    "silu": _lo_silu, "gelu": _lo_gelu, "relu": _lo_relu, "softplus": _lo_softplus,
    "tril": _lo_tril,
    "embedding": _lo_gather, "index_select": _lo_gather, "index": _lo_gather,
    "gather": _lo_gather,
    "cat": _lo_join, "stack": _lo_join,
    "constant_pad_nd": _lo_pad,
    "slice_scatter": _lo_update_slice, "select_scatter": _lo_update_slice,
    "index_put": _lo_scatter, "scatter": _lo_scatter,
    "_to_copy": _lo_pass("convert_element_type"), "clone": _lo_pass("copy"),
    "flip": _lo_pass("rev"), "roll": _lo_pass("rev"),
    "repeat": _lo_pass("broadcast_in_dim"),
}
for _n in ("arange", "full", "full_like", "new_full", "zeros", "zeros_like",
           "new_zeros", "ones", "ones_like", "new_ones", "empty", "empty_like",
           "new_empty", "empty_strided", "scalar_tensor", "rand", "rand_like",
           "uniform", "bernoulli", "exponential",
           "randn", "randn_like", "randint", "randint_like", "normal", "randperm",
           "linspace", "eye"):
    _LOWER[_n] = _lo_const

#: the ops whose output's value (or shape) depends on the data, eagerly
#: following one branch: exact inputs make them constants, others TOP
_DATA_DEPENDENT = frozenset({
    "topk", "sort", "argsort", "argmax", "argmin", "nonzero", "masked_select",
    "unique", "_unique", "_unique2", "unique_consecutive", "unique_dim",
    "multinomial", "mode", "median", "nanmedian", "kthvalue", "searchsorted",
    "bucketize", "bincount", "histc", "nonzero_static", "msort"})
#: ops that hand a tensor's value to Python (``.item()``, ``bool()``)
_ESCAPES = frozenset({"_local_scalar_dense", "is_nonzero", "equal", "allclose"})

#: view ops with several results (``jnp.split``'s twins)
_SPLITS = frozenset({"split", "split_with_sizes", "chunk", "unbind", "tensor_split",
                     "unsafe_split"})

_VIEW_PRIMS = {
    "unsqueeze": "expand_dims", "squeeze": "squeeze",
    "view": "reshape", "_unsafe_view": "reshape", "reshape": "reshape",
    "_reshape_alias": "reshape", "flatten": "reshape", "unflatten": "reshape",
    "view_as": "reshape",
    "expand": "broadcast_in_dim", "expand_as": "broadcast_in_dim",
    "permute": "transpose", "transpose": "transpose", "t": "transpose",
    "swapaxes": "transpose", "movedim": "transpose",
    "alias": "copy", "detach": "copy", "lift_fresh": "copy",
}


def _data_dependent(ctx: _Ctx, name: str, ins: list, outs: list) -> None:
    """Outputs of an op that follows the data: constants of exact inputs,
    TOP of others (``numerics/unsupported-op``)."""
    if all(ev.exact() and ev.payload is None for ev in ins):
        for o in outs:
            ctx.write_tensor(o, _from_array(o) if o.numel() <= _CONST_SIZE_LIMIT
                             else ErrVal())
        return
    ctx.note_unsupported(name, "data-dependent op on a non-exact value: the eager "
                         "run follows one branch; bound is unconstrained downstream")
    top = _top(_in_tags(ins))
    for o in outs:
        ctx.write_tensor(o, top)


def _bind(func, args, kwargs) -> dict:
    out = {}
    for i, arg in enumerate(func._schema.arguments):
        if i < len(args) and not arg.kwarg_only:
            out[arg.name] = args[i]
        elif arg.name in kwargs:
            out[arg.name] = kwargs[arg.name]
        elif arg.has_default_value():
            out[arg.name] = arg.default_value
        else:
            out[arg.name] = None
    return out


def _tensors_of(tree) -> list:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _step(ctx: _Ctx, func, args, kwargs, out) -> None:
    """Interpret one ATen op of the run (its outputs are already made)."""
    name = func._schema.name.split("::", 1)[-1]
    ins = _tensors_of((args, kwargs))
    outs = _tensors_of(out)
    in_keys = {_skey(t) for t in ins}
    a = _bind(func, args, kwargs)
    written = [a[arg.name] for arg in func._schema.arguments
               if arg.alias_info is not None and arg.alias_info.is_write
               and isinstance(a.get(arg.name), torch.Tensor)]
    if not written and (func.is_view or (outs and all(_skey(o) in in_keys
                                                      for o in outs))):
        src = ins[0] if ins else None
        prim = _VIEW_PRIMS.get(name, "slice")
        if src is not None and (name in _SPLITS or id(src) in ctx.split_views):
            # the reference's ``split`` has several results, so it tracks no
            # const of them: its parts (and their views) read as the whole
            ev = ctx.read_tensor(src)
            ev = dataclasses.replace(ev, const=None) if ev.payload is None else ev
            for o in outs:
                ctx.split_views[id(o)] = ev
        for o in outs:
            params = {}
            if prim == "broadcast_in_dim":
                r, rs = o.dim(), src.dim()
                params = {"shape": tuple(o.shape),
                          "broadcast_dimensions": tuple(range(r - rs, r))}
            ctx.defs[id(o)] = _Eqn(prim, [src], [o], params)
        return
    if name in _ESCAPES:
        evs = [ctx.read_tensor(t) for t in ins]
        tags = _in_tags(evs)
        if tags:
            ctx.note_unsupported(name, "a non-exact value leaves the program as "
                                 "a Python scalar: the bound is unconstrained "
                                 "for its tags")
            ctx.escaped |= tags
        return
    if name in _DATA_DEPENDENT:
        _data_dependent(ctx, name, [ctx.read_tensor(t) for t in ins], outs)
        return
    target = written[0] if written else None
    if written:
        base = name[:-1] if name.endswith("_") else name
        if base in _VIEW_PRIMS:       # a metadata-only in-place view change
            return
        a = {k: v for k, v in a.items() if k != "out"}
        if base == "copy":
            lower, a = _lo_pass("convert_element_type"), {"self": a["src"]}
        elif base in ("fill", "zero"):
            lower, a, base = _lo_const, {"fill_value": a.get("value", 0)}, "full"
        else:
            lower = _LOWER.get(base)
        name, outs = base, [target]
    else:
        lower = _LOWER.get(name)
    if lower is None:
        ctx.note_unsupported(name, "no transfer rule; bound is unconstrained "
                             "downstream")
        top = _top(_in_tags([ctx.read_tensor(t) for t in ins]))
        for o in outs:
            ctx.write_partial(o, top) if o is target else ctx.write_tensor(o, top)
        return
    L = _Lower(ctx, name, a, outs)
    last = len(ctx.held)
    lower(L)
    # the op's outputs take the values of the equations that made them; an
    # in-place op writes (part of) its storage
    for v in ctx.held[last:]:
        if isinstance(v, _Var) and isinstance(v.real, torch.Tensor) and id(v) in ctx.venv:
            ev, eqn = ctx.venv[id(v)], ctx.defs.get(id(v))
            if v.real is target:
                ctx.write_partial(target, ev, eqn)
            else:
                ctx.write_tensor(v.real, ev, eqn)
            if id(v) in ctx.flash:
                ctx.flash[id(v.real)] = ctx.flash[id(v)]


#: kernel wrappers that compute one matmul of ``x`` against a payload
_MATMUL_KERNELS = frozenset({
    "cuda:onehot", "cuda:maskfree", "cuda:dense", "cuda:grouped",
    "cuda:grouped_maskfree", "cuda:grouped_dense", "draft:histream",
    "draft:maskfree_p"})


class _Interp(TorchDispatchMode):
    """The recorders of one :func:`analyze` call: every ATen op, and every
    kernel call through ``kernels.hooks``."""

    def __init__(self, ctx: _Ctx):
        super().__init__()
        self.ctx = ctx

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ctx = self.ctx
        ctx.held.extend(_tensors_of((args, kwargs)))
        ctx.held.extend(_tensors_of(out))
        if not ctx.in_kernel:
            _step(ctx, func, args, kwargs, out)
        return out

    # -- kernel calls (kernels.hooks) ------------------------------------
    def kernel(self, name: str, fn, *args, **kwargs):
        ctx = self.ctx
        bound = inspect.signature(fn).bind(*args, **kwargs).arguments
        named = {k: v for k, v in bound.items() if isinstance(v, torch.Tensor)}
        ctx.held.extend(named.values())
        ctx.in_kernel += 1
        try:
            with hooks.paused():
                out = fn(*args, **kwargs)
        finally:
            ctx.in_kernel -= 1
        if ctx.in_kernel:
            return out
        with _disable_current_modes():
            self._kernel_value(name, named, _tensors_of(out))
        return out

    def _kernel_value(self, name: str, named: dict, outs: list) -> None:
        ctx = self.ctx
        ctx.counts[f"kernel:{name}"] += 1
        evs = {k: ctx.read_tensor(t) for k, t in named.items()}
        fields = [k for k in ("mask", "hi", "lo", "scale") if k in named]
        xk = next(iter(named))
        tags = frozenset().union(*(evs[k].payload or frozenset() for k in fields))
        if name in _MATMUL_KERNELS and len(tags) == 1 \
                and all(evs[k].payload is not None for k in fields) \
                and evs[xk].payload is None and next(iter(tags)) in ctx.stats:
            tag = next(iter(tags))
            x = named[xk]
            eqn = _Eqn("dot_general", [x, named[fields[-1]]], outs[:1],
                       {"k": x.shape[-1]})
            ev = _cap(_rule_dot(ctx, eqn, [evs[xk], _from_stats(ctx.stats[tag], tag)]))
        else:
            ctx.note_unsupported(name, "kernel call not interpreted; bound is "
                                 "unconstrained downstream")
            eqn, ev = None, _top(_in_tags(evs.values()))
        for o in outs:
            ctx.write_tensor(o, ev, eqn)

    # -- collectives (models.sharding) -----------------------------------
    def collective(self, primitive: str, x: torch.Tensor, width: int,
                   out: Optional[torch.Tensor] = None) -> None:
        if out is None or _skey(out) == _skey(x):
            return
        ctx = self.ctx
        with _disable_current_modes():
            ev = ctx.read_tensor(x)
            if primitive == "psum":    # no transfer rule in the reference
                ctx.note_unsupported("psum", "no transfer rule; bound is "
                                     "unconstrained downstream")
                ev = _top(_in_tags([ev]))
            else:
                ev = _rule_pass(ctx, None, [ev])
            ctx.write_tensor(out, ev)


# ---------------------------------------------------------------------------
# public API


@dataclasses.dataclass
class NumericsResult:
    """Statically derived output-error bounds of one recorded program."""

    per_tag: dict        # payload leaf -> sound output-error bound
    total: float         # sound end-to-end bound (all leaves quantized)
    per_tag_err2: dict   # payload leaf -> estimated output-error power
    total_err2: float
    interval: tuple      # joint output interval (lo, hi)
    unsupported: tuple   # ops the interpreter gave up on
    #: matched / missed refinements (``flash_match``, ``flash_miss``,
    #: ``rms_match``, ``rms_miss``) and interpreted kernel calls
    #: (``kernel:<name>``); not part of the JSON
    counts: dict = dataclasses.field(default_factory=dict, compare=False)

    def to_json(self) -> dict:
        return {"per_tag": {t: float(v) for t, v in self.per_tag.items()},
                "total": float(self.total),
                "per_tag_err2": {t: float(v)
                                 for t, v in self.per_tag_err2.items()},
                "total_err2": float(self.total_err2),
                "interval": [float(self.interval[0]),
                             float(self.interval[1])],
                "unsupported": list(self.unsupported)}


def _match_suffix(names: list, table: dict) -> Optional[str]:
    """Resolve a leaf path against plan-entry / seed names, tolerating the
    argument-position prefix the input walk adds (``0/...``)."""
    for i in range(len(names)):
        cand = "/".join(names[i:])
        if cand in table:
            return cand
    return None


def _seed_leaf(ctx: _Ctx, path, leaf) -> ErrVal:
    from repro_torch.analysis.dataflow import _key_name
    names = [_key_name(p) for p in path]
    field = names[-1] if names else ""
    if field in PAYLOAD_KEYS or field == SCALE_KEY:
        tag = _match_suffix(names[:-1], ctx.stats)
        if tag is not None:
            return ErrVal(payload=frozenset({tag}))
    full = _match_suffix(names, ctx.seeds)
    if full is not None:
        s = ctx.seeds[full]
        base = _from_array(leaf)
        return ErrVal(lo=base.lo - s.err, hi=base.hi + s.err,
                      err={full: s.err} if s.err else {}, ms=base.ms,
                      err2={full: s.err2} if s.err2 else {},
                      const=base.const if s.err == 0.0 else None)
    return _from_array(leaf)


def analyze(fn, *args, stats=None, seeds=None, location: str = "<fn>",
            **kwargs):
    """Abstractly interpret ``fn(*args, **kwargs)`` and return
    ``(NumericsResult, Report)``.

    ``fn`` runs once, eagerly, on the tensors it is given (on the card or
    the CPU) under the recorders of the module docstring.  ``stats`` maps
    payload leaf names (plan-entry names) to :class:`LeafStats` — usually
    :func:`leaf_stats_from_plan`.  ``seeds`` maps ordinary (float) leaf
    path names to :class:`LeafStats` whose ``err``/``err2`` are injected at
    that input — the mechanism behind :func:`output_gains`.  The
    reference's ``scan_unroll_limit`` has no counterpart: an eager run has
    no scan to unroll."""
    from repro_torch.analysis.dataflow import _flat_inputs
    from repro_torch.core.apply import _flatten_with_path

    report = Report()
    ctx = _Ctx(stats=dict(stats or {}), report=report, location=location,
               seeds=dict(seeds or {}))
    for path, leaf in _flat_inputs(args, kwargs):
        ctx.seed(leaf, _seed_leaf(ctx, path, leaf))
    if hooks.active is not None:
        raise RuntimeError("numerics.analyze: a trace is already active")
    interp = _Interp(ctx)
    hooks.active = interp
    try:
        with torch.no_grad(), interp:
            out = fn(*args, **kwargs)
    finally:
        hooks.active = None
    outs = [leaf for _, leaf in _flatten_with_path(out) if isinstance(leaf, torch.Tensor)]
    joined = _join_vals([_read(ctx, o) for o in outs])
    if joined.payload is not None:
        joined = _top(joined.payload)
    for t in ctx.escaped:
        joined.err[t] = joined.err2[t] = INF
    result = NumericsResult(
        per_tag={t: float(v) for t, v in sorted(joined.err.items())},
        total=float(joined.total_err()),
        per_tag_err2={t: float(v) for t, v in sorted(joined.err2.items())},
        total_err2=float(sum(joined.err2.values())),
        interval=(joined.lo, joined.hi),
        unsupported=tuple(sorted(ctx.unsupported)),
        counts=dict(sorted(ctx.counts.items())))
    return result, report


def output_gains(fn, *args, names, location: str = "<fn>", **kwargs) -> dict:
    """Per-leaf output noise gains: run one :func:`analyze` pass over the
    float program with a unit mean-square error seeded at every leaf in
    ``names``.  The unit seed saturates at the leaf's own range (``err2``
    is width^2-capped, see :func:`_cap`), so the output ``err2`` per leaf
    is that leaf's *range-aware* gain ``G`` — the response to full-range
    noise at that tensor; seeds small against every interval they cross
    propagate linearly instead.  Predicted output error power for a
    schedule is scored as ``G * noise_power(cfg)``."""
    seeds = {n: LeafStats(lo=0.0, hi=0.0, err=0.0, err2=1.0, ms=0.0)
             for n in names}
    res, _ = analyze(fn, *args, seeds=seeds, location=location, **kwargs)
    return {n: float(res.per_tag_err2.get(n, 0.0)) for n in names}


def _tensors(tree) -> list:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _tensors(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    return []


def measured_error(fn, args_a, args_b) -> float:
    """Teacher-forced measured output error: ``max |fn(*args_a) -
    fn(*args_b)|`` over all output tensors, in float64 on their device."""
    worst = 0.0
    for a, b in zip(_tensors(fn(*args_a)), _tensors(fn(*args_b))):
        if a.numel():
            d = a.detach().to(torch.float64) - b.detach().to(a.device, torch.float64)
            worst = max(worst, float(d.abs().max()))
    return worst


def check_error_budget(result: NumericsResult, budget: dict,
                       location: str = "<schedule>") -> Report:
    """Compare a :class:`NumericsResult` against a declared error budget
    (``{"total": x, "per_layer": y-or-{name: y}}``); every violation is a
    ``numerics/budget-exceeded`` error finding."""
    report = Report()
    total_cap = budget.get("total")
    if total_cap is not None and result.total > float(total_cap):
        report.add("error", "numerics/budget-exceeded", location,
                   f"static end-to-end output-error bound {result.total:.6g}"
                   f" exceeds the declared total budget {total_cap:.6g}")
    per = budget.get("per_layer")
    if per is not None:
        caps = per if isinstance(per, dict) else {
            t: float(per) for t in result.per_tag}
        for t, cap in sorted(caps.items()):
            bound = result.per_tag.get(t)
            if bound is not None and bound > float(cap):
                report.add("error", "numerics/budget-exceeded",
                           f"{location}: {t}",
                           f"static per-layer bound {bound:.6g} exceeds "
                           f"the declared per-layer budget {float(cap):.6g}")
    return report
