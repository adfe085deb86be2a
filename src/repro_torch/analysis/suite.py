"""The verification suite behind ``python -m repro_torch.analysis``: builds
small-but-real instances of the port's entry points — local dispatch, each
registered ``sharded:*`` variant under col/row TP layouts, the ``cache:*``
page codecs and the scheduler's serving lanes — and runs the passes over
them (twin of ``repro.analysis.suite``):

* packed dataflow (:mod:`repro_torch.analysis.dataflow`), including the
  draft-payload proof (:func:`verify_draft_payload`);
* registry audit (:mod:`repro_torch.analysis.registry_audit`);
* launch-contract lint (:mod:`repro_torch.analysis.pallas_lint`);
* recompile lint (:mod:`repro_torch.analysis.recompile`);
* numerics (:mod:`repro_torch.analysis.numerics`): the static output-error
  bound of a packed forward and its soundness self-check
  (:func:`verify_numerics`).

Every scenario takes a ``device``.  On the CPU the ``cuda`` family of the
matmul lowerings cannot run (``engine.variants._on_card``), so the lanes
run the ``torch`` family there, and the fused-attention gate checks the
selection by pure logic and records K4's plain route (a CPU tensor takes
it); on the card the same calls run the kernels.  Without a mesh the
sharded scenarios run on a 1 x 1 mesh-like object, where every collective
is recorded with width 1 (the reference traces a 1-device mesh alike).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.analysis import dataflow, pallas_lint, recompile, registry_audit
from repro_torch.analysis.report import Report
from repro_torch.core.policy import StruMConfig

__all__ = ["PASSES", "run_all", "tiny_model", "verify_local_apply",
           "verify_sharded_variants", "verify_cache_codecs",
           "verify_scheduler_lanes", "verify_fused_attention",
           "verify_draft_payload", "verify_numerics", "check_cache_pools",
           "build_tiny_scheduler", "draft_poison_check"]

PASSES = ("dataflow", "registry", "pallas", "recompile", "numerics", "draft")

_WCFG = StruMConfig(method="mip2q", w=16, p=0.5, L=5)
_KVCFG = StruMConfig(method="dliq", w=16, p=0.5, q=4)
_KVCFG_MIP = StruMConfig(method="mip2q", w=16, p=0.5, L=7)


class OneDeviceMesh:
    """A mesh-like object of axes of size 1 (``models.sharding`` reads
    ``axis_names`` / ``shape``): every collective over it is the identity."""

    def __init__(self, names=("data", "model")):
        self.axis_names = tuple(names)
        self.shape = {n: 1 for n in names}

    def size(self, i: int = 0) -> int:
        return 1

    def get_local_rank(self, axis) -> int:
        return 0

    def __getitem__(self, name):
        return OneDeviceMesh((name,))


def tiny_model(arch: str = "qwen2_7b", device="cpu"):
    """(ModelConfig, float32 params) for a smoke-scale architecture."""
    from repro_torch.configs.base import get_smoke_config
    from repro_torch.models import model_defs
    from repro_torch.models.params import init_params

    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    params = init_params(model_defs(cfg), seed=0, device=device,
                         dtype_override="float32")
    return cfg, params


def _payload_bytes(wleaf: dict) -> int:
    return int(sum(wleaf[k].numel() for k in ("mask", "hi", "lo")))


def _leaf(k: int, n: int, cfg: StruMConfig, lead: tuple = (), device="cpu") -> dict:
    from repro_torch.models.quantize import _pack_leaf
    return {f: t.to(device) for f, t in
            _pack_leaf(torch.zeros(lead + (k, n)), cfg).items()}


# ------------------------------------------------------------- scenarios --

def verify_local_apply(device="cpu") -> Report:
    """Single-device dispatch: decode-exactly-once, no collectives."""
    from repro_torch.engine.dispatch import dispatch

    report = Report()
    k, n = 64, 128
    for cfg, label in ((_WCFG, "mip2q"), (_KVCFG, "dliq"),
                       (StruMConfig(method="sparsity", w=16, p=0.5),
                        "sparsity")):
        wleaf = _leaf(k, n, cfg, device=device)
        report.extend(dataflow.verify(
            lambda lf, x, _cfg=cfg: dispatch(lf, x, strum=_cfg),
            wleaf, torch.zeros((4, k), device=device),
            location=f"engine.apply[{label}]"))
    return report


def verify_sharded_variants(cfg: StruMConfig = _WCFG, mesh=None, device="cpu",
                            stats: Optional[dict] = None) -> Report:
    """Prove the Eq.-1 gather invariant for every registered ``sharded:*``
    variant on ``mesh`` (default a 1 x 1 one): packed-only collectives,
    decode-once, global gathered bytes == mask+hi+lo == K x N x
    compression_ratio.  ``stats``, if given, receives each variant's
    ``collective_stats`` (``all_gather_stats``'s dict)."""
    from repro_torch.engine.registry import list_variants
    from repro_torch.models import sharding as shd

    mesh = OneDeviceMesh() if mesh is None else mesh
    report = Report()
    k, n = 128, 256
    for name, variant in sorted(list_variants().items()):
        if not variant.sharded:
            continue
        if variant.grouped:
            sub, lead = mesh["data"], (2,)      # the reference's 1-D mesh
            wleaf = _leaf(k, n, cfg, lead=lead, device=device)
            spec = shd.P(None, ("data",), None, None)
            local = {f: shd.shard_slice(wleaf[f], spec, sub) if f != "scale"
                     else wleaf[f] for f in ("mask", "hi", "lo", "scale")}
            x = torch.zeros(lead + (4, k), device=device)

            def run(lf, xg, _v=variant, _m=sub):
                return _v.fn(lf, xg, cfg=cfg, mesh=_m, fsdp=("data",), k_dim=k,
                             out_dtype=torch.float32)
            cases = [(name, run, local, x, sub, n * lead[0])]
        else:
            cases = []
            for pattern in ("col", "row"):
                def run(lf, xx, _v=variant, _p=pattern):
                    return _v.fn(lf, xx, cfg=cfg, mesh=mesh, fsdp=("data",),
                                 pattern=_p, k_dim=k, out_dtype=torch.float32)
                cases.append((f"{name}[{pattern}]", run, _leaf(k, n, cfg, device=device),
                              torch.zeros((4, k), device=device), mesh, n))
        for where, run, leaf, x, m, n_out in cases:
            trace = dataflow.trace_dataflow(run, leaf, x)
            if stats is not None:
                stats[where] = trace.stats(mesh=m)
            full = _leaf(k, n, cfg, lead=(2,) if variant.grouped else (), device=device)
            report.extend(dataflow.verify(
                run, leaf, x, location=where, mesh=m, trace=trace,
                expected_payload_bytes=_payload_bytes(full),
                cfg=cfg, k_dim=k, n_out=n_out))
    return report


def verify_cache_codecs(kv: StruMConfig = _KVCFG, device="cpu") -> Report:
    """Packed page pools: decode-once, no fp payload fields, and payload
    bytes at the Eq.-1 page ratio."""
    from repro_torch.engine import cache as cache_mod

    report = Report()
    page, feat, n_pages = 64, 32, 8
    for backend in (None, "cuda"):
        spec = cache_mod.build_cache_spec(kv, page_size=page, feat=feat,
                                          device=device, backend=backend)
        pool = cache_mod.encode_page(torch.zeros((n_pages, page, feat), device=device),
                                     kv)
        loc = f"cache.gather_decode_pages[{spec.variant}]"
        for f in ("mask", "hi", "lo"):
            if pool[f].is_floating_point():
                report.add("error", "cache/fp-page", f"{loc}/{f}",
                           f"payload pool field is {pool[f].dtype}")
        report.extend(dataflow.verify(
            lambda p, ids, _s=spec, _b=backend: cache_mod.gather_decode_pages(
                p, ids, _s, backend=_b),
            pool, torch.zeros((2, 3), dtype=torch.int32, device=device),
            location=loc))
        want = cache_mod.page_payload_bytes(page, feat, kv)
        got = sum(pool[f].numel() // n_pages for f in ("mask", "hi", "lo"))
        if got != want:
            report.add("error", "dataflow/eq1-bytes", loc,
                       f"page payload {got} B != page_payload_bytes {want}")
    return report


def check_cache_pools(pools: dict, spec, location: str) -> Report:
    """No fp bytes inside sealed packed pages (the pool-side static check)."""
    from repro_torch.core.apply import _named_leaves

    report = Report()
    if not getattr(spec, "packed", False):
        return report
    for name, arr in _named_leaves(pools):
        if name.rsplit("/", 1)[-1] == "scale" or not isinstance(arr, torch.Tensor):
            continue
        if arr.is_floating_point():
            report.add("error", "cache/fp-page", f"{location}/{name}",
                       f"packed pool stores {arr.dtype} — fp bytes leak "
                       f"out of sealed pages")
    return report


def build_tiny_scheduler(cfg, params, *, kv=_KVCFG, wcfg=_WCFG,
                         n_slots: int = 2, max_len: int = 48,
                         cache_backend=None, speculative: int = 0,
                         draft=None, device="cpu", **kwargs):
    """A packed-weights, packed-KV scheduler for lane analysis."""
    from repro_torch import engine
    from repro_torch.serving import BatchScheduler

    plan = engine.build_plan(params, cfg=wcfg, float_only=True, device=device)
    return BatchScheduler(cfg, params, n_slots=n_slots, max_len=max_len,
                          plan=plan, kv_cache=kv, page_size=kv.w,
                          cache_backend=cache_backend, speculative=speculative,
                          draft=draft, device=device, **kwargs)


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree.clone() if isinstance(tree, torch.Tensor) else tree


def decode_lane_args(sched, params=None) -> tuple:
    """The decode lane's arguments on an idle scheduler: every slot active
    at cache length 0, the page table all page 0, the hot state a copy
    (the lane writes it in place)."""
    ns, pps, dev = sched.n_slots, sched.pages_per_seq, sched.device
    return (sched.params if params is None else params,
            torch.zeros((ns, 1), dtype=torch.long, device=dev), sched.pools,
            _clone(sched.hot), torch.zeros((ns,), dtype=torch.int32, device=dev),
            torch.zeros((ns, pps), dtype=torch.int32, device=dev),
            torch.ones((ns,), dtype=torch.bool, device=dev))


def verify_scheduler_lanes(sched, location: str = "scheduler") -> Report:
    """Record both serving lanes once and run the dataflow pass: weights
    and sealed pages decode exactly once, nothing gathers fp."""
    report = check_cache_pools(sched.pools, sched.spec, f"{location}/pools")
    dev, pps = sched.device, sched.pages_per_seq
    report.extend(dataflow.verify(sched._decode, *decode_lane_args(sched),
                                  location=f"{location}/decode-lane"))
    scalar = lambda v: torch.tensor(v, device=dev)  # noqa: E731
    report.extend(dataflow.verify(
        sched._chunk_prefill, sched.params,
        torch.zeros((1, sched.prefill_chunk), dtype=torch.long, device=dev),
        sched.pools, _clone(sched.hot),
        torch.zeros((sched.n_slots, pps), dtype=torch.int32, device=dev),
        scalar(0), scalar(0), scalar(1), location=f"{location}/prefill-lane"))
    return report


def fused_read_bytes(sched, lens=None, table=None) -> int:
    """The pool bytes one decode tick's fused attention reads: 2 (K and V)
    x every attention layer's pool x a page's mask + hi + lo bytes x the
    (slot, page) entries read.  Without ``lens`` / ``table`` that is every
    entry of the table (slots x pages a slot): what the plain route
    gathers and ``attn/fused/packed_bytes`` counts, the table's capacity.
    With the tick's cache lengths and page table it is the entries K4 reads
    on the card: a page id in the pool, below the slot's ``lens //
    page_size`` sealed pages."""
    from repro_torch.engine import cache as cache_mod
    from repro_torch.serving import pages as pages_mod
    ppb = cache_mod.page_payload_bytes(sched.spec.page_size,
                                       pages_mod.attn_feat_dim(sched.cfg),
                                       sched.spec.cfg)
    pools = [pool for pool in sched.pools.values() if pool]
    n_pools = sum(pool["k"]["mask"].shape[0] for pool in pools)
    if lens is None and table is None:
        return n_pools * 2 * sched.n_slots * sched.pages_per_seq * ppb
    table = torch.as_tensor(table).to("cpu", torch.long).reshape(sched.n_slots, -1)
    sealed = torch.as_tensor(lens).to("cpu", torch.long).reshape(-1, 1) \
        // sched.spec.page_size
    n_pages = pools[0]["k"]["mask"].shape[1]
    live = (table >= 0) & (table < n_pages) & \
        (torch.arange(table.shape[1])[None] < sealed)
    return n_pools * 2 * int(live.sum()) * ppb


def verify_fused_attention(arch: str = "qwen2_7b", model=None, device="cpu") -> Report:
    """The Eq.-1 HBM gate of the fused decode lane.

    For packed q=4 codecs (DLIQ and MIP2Q) under the ``cuda`` cache family
    the scheduler must select ``cache:attn_fused`` (on the CPU by the
    selection alone: ``select_attn_variant(..., backend="cuda")``), and the
    recorded decode step's pool reads must take exactly the mask+hi+lo
    payload: no raw fp page bytes, no post-decode re-gather
    (``dataflow/fp-page``), each pool decoded exactly once.  Bytes count
    every attention layer of the step (the port runs eagerly, layer by
    layer): on the CPU the plain route gathers every entry of the table, on
    the card K4 reads the live ones (``fused_read_bytes``).
    """
    from repro_torch.engine.cache import select_attn_variant
    from repro_torch.serving import pages as pages_mod

    report = Report()
    cfg, params = model or tiny_model(arch, device)
    feat = pages_mod.attn_feat_dim(cfg)
    for kv, label in ((_KVCFG, "dliq_q4"), (_KVCFG_MIP, "mip2q_L7")):
        loc = f"{arch}/attn-fused[{label}]"
        chosen = select_attn_variant(kv, page_size=kv.w, feat=feat, head_dim=cfg.hd,
                                     backend="cuda", device=device).name
        sched = build_tiny_scheduler(cfg, params, kv=kv, cache_backend="cuda",
                                     device=device)
        if chosen != "cache:attn_fused" or sched.spec.attn_variant != chosen:
            report.add("error", "attn/unfused-lane", loc,
                       f"packed codec {kv.method} w={kv.w} q={kv.q} selected "
                       f"{sched.spec.attn_variant!r}")
            continue
        args = decode_lane_args(sched)
        want = fused_read_bytes(sched, lens=args[4], table=args[5]) \
            if torch.device(device).type == "cuda" else fused_read_bytes(sched)
        report.extend(dataflow.verify(
            sched._decode, *args, location=f"{loc}/decode-lane",
            expected_gather_packed_bytes=want, forbid_fp_pages=True))
    return report


def _packed_leaves(tree) -> dict:
    from repro_torch.core.apply import map_named
    from repro_torch.engine.draft import _is_packed_leaf
    leaves: dict = {}

    def visit(name, leaf):
        if _is_packed_leaf(leaf):
            leaves[name] = leaf
        return leaf
    map_named(visit, tree, is_leaf=_is_packed_leaf)
    return leaves


def verify_draft_payload(sched, location: str = "scheduler",
                         trace: Optional[dataflow.DataflowTrace] = None) -> Report:
    """Proof that the draft lane reads a strict byte-subset of the target
    payload — speculative decoding's "free draft model" claim.

    Three checks on a ``speculative=k`` scheduler:

    1. ``draft/extra-bytes`` — every packed leaf of the draft plan holds the
       *same* mask/hi/lo/scale tensors (by identity and ``data_ptr()``) as
       the target plan: zero additional weight bytes on the device.
    2. ``draft/stream-read`` — in one recorded draft decode step, no op or
       kernel call is handed a stream its leaf's draft mode skips
       (``histream`` -> lo; ``maskfree_p`` -> mask + lo;
       ``kernels.ops.draft_field_set``).
    3. ``draft/no-subset`` — the payload bytes the step reads are strictly
       below the full payload AND equal ``draft_plan_bytes``'s draft bytes.
    """
    from repro_torch.engine.draft import draft_field_set, draft_plan_bytes

    report = Report()
    if not getattr(sched, "speculative", 0):
        report.add("error", "draft/no-subset", location,
                   "scheduler has no draft lane (speculative=0); nothing "
                   "to prove")
        return report
    modes = sched.draft_plan.meta.get("draft", {})
    target = _packed_leaves(sched.plan.params)
    drafted = _packed_leaves(sched._draft_params)
    for name, dleaf in sorted(drafted.items()):
        tleaf = target.get(name)
        for f in ("mask", "hi", "lo", "scale"):
            if tleaf is None or dleaf[f] is not tleaf[f] \
                    or dleaf[f].data_ptr() != tleaf[f].data_ptr():
                report.add("error", "draft/extra-bytes",
                           f"{location}/{name}/{f}",
                           "draft plan does not share the target plan's "
                           "payload tensor — the draft would cost extra "
                           "device memory")

    if trace is None:
        trace = dataflow.trace_dataflow(
            sched._draft_decode, *decode_lane_args(sched, sched._draft_params))
    read = {(tag, f) for tag, f, _ in trace.read_regions}
    live_bytes = full_bytes = 0
    for name, dleaf in sorted(drafted.items()):
        mode = modes.get(name, "")
        streamed = set(draft_field_set(mode)) if mode else {"mask", "hi", "lo"}
        for f in ("mask", "hi", "lo"):
            is_live = (f"0/0/{name}", f) in read
            full_bytes += dleaf[f].numel()
            if is_live:
                live_bytes += dleaf[f].numel()
            if mode and f not in streamed and is_live:
                report.add("error", "draft/stream-read",
                           f"{location}/{name}/{f}",
                           f"draft mode {mode!r} declares the {f} stream "
                           f"skipped, but the recorded draft decode step "
                           f"reads it")

    decl = draft_plan_bytes(sched.draft_plan)
    if not any(modes.values()) or live_bytes >= full_bytes:
        report.add("error", "draft/no-subset", location,
                   f"draft lane live payload {live_bytes} B is not a "
                   f"strict subset of the full payload {full_bytes} B")
    elif live_bytes != decl["draft_bytes"]:
        report.add("error", "draft/no-subset", location,
                   f"recorded live payload {live_bytes} B != declared draft "
                   f"bytes {decl['draft_bytes']} B "
                   f"(draft_plan_bytes drifted from the recorded truth)")
    return report


def draft_poison_check(sched) -> dict:
    """Run one draft decode step twice, the second time with every drafted
    leaf's skipped streams replaced by copies filled with 0xFF: a draft
    kernel that never reads them gives the same logits bit for bit.
    Returns ``{"leaves", "poisoned_bytes", "max_abs_diff"}``."""
    from repro_torch.core.apply import map_named
    from repro_torch.engine.draft import _is_packed_leaf, draft_field_set

    modes = sched.draft_plan.meta.get("draft", {})
    count = {"leaves": 0, "bytes": 0}

    def poison(name, leaf):
        mode = modes.get(name, "")
        if not mode:
            return leaf
        out = dict(leaf)
        for f in ("mask", "hi", "lo"):
            if f not in draft_field_set(mode):
                out[f] = torch.full_like(leaf[f], 0xFF if leaf[f].dtype == torch.uint8
                                         else -1)
                count["bytes"] += leaf[f].numel()
        count["leaves"] += 1
        return out
    bad = map_named(poison, sched._draft_params, is_leaf=_is_packed_leaf)
    want = sched._draft_decode(*decode_lane_args(sched, sched._draft_params))[0]
    got = sched._draft_decode(*decode_lane_args(sched, bad))[0]
    return {"leaves": count["leaves"], "poisoned_bytes": count["bytes"],
            "max_abs_diff": float((got - want).abs().max()),
            "bit_equal": bool(torch.equal(got, want))}


_NUMERICS_CFGS = (StruMConfig(method="dliq", w=8, p=0.5, q=4),
                  StruMConfig(method="mip2q", w=8, p=0.5, L=3))


def verify_numerics(arch: str = "qwen2_7b", cfgs=_NUMERICS_CFGS,
                    device="cpu") -> Report:
    """Numerics pass + soundness self-check on a real packed forward.

    For each schedule: derive the static per-layer and end-to-end
    output-error bound with :func:`repro_torch.analysis.numerics.analyze`,
    then run the float and the packed forward teacher-forced on the same
    tokens and require ``static bound >= measured error`` — a violated
    inequality is a bug in the interpreter itself and reports
    ``numerics/unsound-bound``.  Schedules that declare an error budget
    (``Budget(error_budget=...)`` via autotune) are additionally checked
    with :func:`repro_torch.analysis.numerics.check_error_budget`.
    """
    from repro_torch import engine
    from repro_torch.analysis import numerics
    from repro_torch.models.transformer import forward_train

    cfg, params = tiny_model(arch, device)
    gen = torch.Generator().manual_seed(3)
    toks = torch.randint(0, cfg.vocab_size, (2, 48), generator=gen).to(device)

    def fn(p, t):
        return forward_train(p, {"tokens": t}, cfg)[0]

    report = Report()
    for scfg in cfgs:
        loc = f"{arch}/numerics[{scfg.method} w={scfg.w} p={scfg.p}]"
        plan = engine.build_plan(params, cfg=scfg, pack=True, device=device)
        stats = numerics.leaf_stats_from_plan(plan, params)
        res, rep = numerics.analyze(fn, plan.params, toks, stats=stats,
                                    location=loc)
        report.extend(rep)
        measured = numerics.measured_error(fn, (params, toks),
                                           (plan.params, toks))
        if res.total < measured:
            report.add("error", "numerics/unsound-bound", loc,
                       f"static bound {res.total:.6g} < measured "
                       f"teacher-forced error {measured:.6g}")
        budget = _schedule_error_budget(plan.schedule)
        if budget is not None:
            report.extend(numerics.check_error_budget(
                res, {"total": budget}, location=loc))
    return report


def _schedule_error_budget(schedule):
    meta = getattr(schedule, "meta", None) or {}
    return (meta.get("budget") or {}).get("error_budget")


# --------------------------------------------------------------- runner --

def run_all(arches=("qwen2_7b",), passes=PASSES, lint_cfgs: Optional[list] = None,
            device="cpu"):
    """Run the requested passes; returns ``(Report, AuditData | None)``."""
    report = Report()
    audit_data = None
    if "registry" in passes:
        r, audit_data = registry_audit.audit_registry()
        report.extend(r)
    if "pallas" in passes:
        report.extend(pallas_lint.lint_pallas(cfgs=lint_cfgs, device=device))
    if "dataflow" in passes:
        report.extend(verify_local_apply(device))
        report.extend(verify_sharded_variants(device=device))
        report.extend(verify_cache_codecs(device=device))
    if "numerics" in passes:
        for arch in arches:
            report.extend(verify_numerics(arch, device=device))
    if "dataflow" in passes or "recompile" in passes:
        for arch in arches:
            cfg, params = tiny_model(arch, device)
            sched = build_tiny_scheduler(cfg, params, device=device)
            if "dataflow" in passes:
                report.extend(verify_scheduler_lanes(
                    sched, location=f"{arch}/scheduler"))
                report.extend(verify_fused_attention(
                    arch, model=(cfg, params), device=device))
            if "recompile" in passes:
                report.extend(recompile.lint_scheduler_recompiles(
                    sched=sched, location=f"{arch}/scheduler"))
                report.extend(recompile.lint_scheduler_recompiles(
                    sched=build_tiny_scheduler(cfg, params, device=device,
                                               prefill="serial"),
                    location=f"{arch}/serial-scheduler"))
    if "draft" in passes:
        for arch in arches:
            cfg, params = tiny_model(arch, device)
            for mode in ("histream", "maskfree_p"):
                sched = build_tiny_scheduler(cfg, params, speculative=2,
                                             draft=mode, device=device)
                report.extend(verify_draft_payload(
                    sched, location=f"{arch}/draft[{mode}]"))
            if "recompile" in passes:
                # the speculative lanes (draft decode / verify / commit)
                # must hold the one-signature invariant too
                sched = build_tiny_scheduler(cfg, params, speculative=2,
                                             device=device)
                report.extend(recompile.lint_scheduler_recompiles(
                    sched=sched, location=f"{arch}/spec-scheduler"))
    return report, audit_data
