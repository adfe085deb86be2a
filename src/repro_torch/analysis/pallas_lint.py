"""Launch-contract lint: holds every ``cuda:*`` / ``cache:*`` / ``draft:*``
registry predicate of the port against its CUDA launcher's
``launch_contract`` (twin of ``repro.analysis.pallas_lint``).

The reference abstract-evaluates each Pallas variant, whose tile contracts
fire as Python asserts at trace time.  A CUDA kernel has no trace, so each
launcher states its refusals as data instead —
``strum_matmul.launch_contract`` (K1-K3, K6-K10),
``strum_attention.launch_contract`` (K4, K5) and
``strum_decode.launch_contract`` (K11), pure functions of shapes and
dtypes that the launchers call first.  Over the reference's sweep
(:func:`default_lint_cfgs` x :func:`_dims_for`; for attention also head
dims :data:`HEAD_DIMS` and page sizes :data:`PAGE_SIZES`), wherever a
predicate accepts a point the contract must accept it, or the point is
``pallas/tile-misaligned`` — the kind of fault F1 (``cache:attn_fused``
selected past K4's limits) and F3 (``cuda:grouped`` past w = 64) were.

On the card (``device="cuda"``) every accepted point is also launched and
its output held to its kernel's plain version (the same wrapper on CPU
copies) within ``KERNEL_TOL`` x its largest |plain| + 1e-6: a launch that
raises is ``pallas/abstract-eval``, an output outside tolerance
``pallas/output-mismatch``.  Then :func:`cxx_refusals` hands a few points
the contracts refuse for a C++ check straight to the C++ entry points, the
Python check skipped: each must come back ``cudaErrorInvalidValue``, never
a launch, which shows the mirror is no looser than the C++.
:func:`lint_block_contracts` property-checks the tiling helpers.
"""
from __future__ import annotations

import itertools
import math
from typing import Optional

import torch

from repro_torch.analysis.report import Report
from repro_torch.core.policy import StruMConfig
from repro_torch.engine import plan as _plan  # noqa: F401  (registers every variant)
from repro_torch.engine.registry import LeafInfo, list_variants
from repro_torch.engine.sharded import _pick_m_pad
from repro_torch.kernels import strum_attention as A
from repro_torch.kernels import strum_decode as D
from repro_torch.kernels import strum_matmul as K

__all__ = ["lint_pallas", "lint_block_contracts", "default_lint_cfgs",
           "cxx_refusals", "VARIANT_KERNELS", "HEAD_DIMS", "PAGE_SIZES",
           "KERNEL_TOL"]

#: registry variant -> the kernel (its ``launch_counts`` key) it launches
VARIANT_KERNELS = {
    "cuda:onehot": "onehot", "cuda:maskfree": "maskfree", "cuda:dense": "dense",
    "cuda:grouped": "grouped_onehot", "cuda:grouped_maskfree": "grouped_maskfree",
    "cuda:grouped_dense": "grouped_dense", "draft:histream": "histream",
    "draft:maskfree_p": "maskfree_p", "cache:cuda_decode": "page_decode",
    "cache:attn_fused": "paged_attention",
    "cache:attn_fused_maskfree": "paged_attention_maskfree"}
HEAD_DIMS = (64, 128, 160, 256, 320)
PAGE_SIZES = (16, 64, 128)
#: |kernel - plain| <= KERNEL_TOL * max|plain| + 1e-6 (chip_smoke phases c, g):
#: f32 sums of the same terms in another order
KERNEL_TOL = 2e-5
_ATTN = dict(b=2, kv=2, r=2, pp=3, n_pages=4)    # the attention probe's geometry


def default_lint_cfgs() -> list:
    """A small config sweep: enough to hit every decode family (onehot,
    maskfree, dense) per method at byte-aligned and default widths."""
    cfgs = []
    for w in (8, 16):
        for p in (0.0, 0.5, 1.0):
            for method in ("sparsity", "dliq", "mip2q"):
                try:
                    cfgs.append(StruMConfig(method=method, w=w, p=p, q=4))
                except ValueError:
                    continue
    return cfgs


def _dims_for(w: int) -> list:
    """(m, k, n) probe shapes: aligned, deliberately ragged, and minimal —
    the launchers must take all three."""
    return [(8, 4 * w, 128), (5, 4 * w + 3, 96), (1, w, 257)]


def _cfg_str(cfg) -> str:
    return f"({cfg.method} w={cfg.w} n_low={cfg.n_low} q={cfg.q})" if cfg else "None"


def _codec_args(kname: str, cfg) -> tuple:
    """``(n_low, q, method)`` as kernel ``kname``'s wrapper hands them to
    its launcher."""
    if kname in ("dense", "grouped_dense"):
        return 0, 1, "sparsity"
    if kname in ("histream", "maskfree_p"):
        return cfg.n_low, 1, "sparsity"
    if kname in ("maskfree", "grouped_maskfree", "paged_attention_maskfree"):
        return cfg.w, cfg.q, cfg.method
    return cfg.n_low, cfg.q, cfg.method


#: the payload fields each kernel is handed
_READS = {"onehot": ("mask", "hi", "lo"), "maskfree": ("lo",), "dense": ("hi",),
          "histream": ("mask", "hi"), "maskfree_p": ("hi",),
          "paged_attention": ("mask", "hi", "lo"), "paged_attention_maskfree": ("lo",),
          "page_decode": ("mask", "hi", "lo")}


def _fields(kname, cfg, lead: tuple, nb: int, n: int) -> dict:
    """``(shape, dtype)`` of each field kernel ``kname`` is handed for a
    payload packed under ``cfg`` (an empty field floored at one row)."""
    from repro_torch.core.packing import field_dims
    rows = dict(zip(("mask", "hi", "lo"), field_dims(cfg.w, cfg.n_low, cfg.q, cfg.method)))
    dtypes = {"mask": torch.uint8, "hi": torch.int8, "lo": torch.uint8}
    return {f: (lead + (nb, max(rows[f], 1), n), dtypes[f])
            for f in _READS[kname.replace("grouped_", "")]}


def _to(tree, dev):
    if isinstance(tree, torch.Tensor):
        return tree.to(dev)
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if hasattr(tree, "_replace"):            # PackedStruM
        return tree._replace(**{f: _to(getattr(tree, f), dev)
                                for f in ("scale", "mask", "hi", "lo")})
    return tree


class _Held:
    """Per-kernel tallies of one lint run on the card."""

    def __init__(self):
        self.points: dict = {}        # kernel -> accepted points
        self.err: dict = {}           # kernel -> (worst |kernel - plain|, limit)

    def accept(self, kname) -> None:
        self.points[kname] = self.points.get(kname, 0) + 1

    def hold(self, kname, got, want, where, report) -> None:
        for g, p in zip(got if isinstance(got, tuple) else (got,),
                        want if isinstance(want, tuple) else (want,)):
            g = g.detach().to("cpu", torch.float32)
            p = p.detach().to(torch.float32)
            limit = KERNEL_TOL * float(p.abs().max()) + 1e-6
            err = float((g - p).abs().max()) if g.shape == p.shape else math.inf
            worst = self.err.get(kname)
            if worst is None or err / limit > worst[0] / worst[1]:
                self.err[kname] = (err, limit)
            if not err <= limit:
                report.add("error", "pallas/output-mismatch", where,
                           f"output {tuple(g.shape)} differs from the plain "
                           f"version's {tuple(p.shape)} by {err:.3g} "
                           f"(limit {limit:.3g})")


def _counts() -> dict:
    return {**K.launch_counts, **A.launch_counts, **D.launch_counts}


def _refused(check, report, where) -> bool:
    try:
        check()
    except ValueError as exc:
        report.add("error", "pallas/tile-misaligned", where,
                   f"the predicate accepts it, the launch contract refuses: {exc}")
        return True
    return False


def _launched(run, report, where):
    try:
        out = run()
        torch.cuda.synchronize()
        return out
    except Exception as exc:  # noqa: BLE001 - the lint classifies any failure
        report.add("error", "pallas/abstract-eval", where,
                   f"launch failed: {type(exc).__name__}: {exc}")
        return None


def _lint_matmul(variant, kname, cfg, report, held, dev, sms, gen) -> None:
    from repro_torch.core.apply import pack_array
    from repro_torch.core.packing import PackedStruM
    from repro_torch.kernels import ops
    from repro_torch.models.quantize import _pack_leaf

    grouped = kname.startswith("grouped_")
    mode = kname if kname in ("histream", "maskfree_p") else ""
    for m, k, n in _dims_for(cfg.w):
        lead = (3,) if grouped else ()
        info = LeafInfo(k_dim=k, n_out=n, lead=lead, draft=mode)
        if not variant.supports(cfg, info):
            continue
        where = (f"{variant.name} cfg={_cfg_str(cfg)} dims=({m},{k},{n})"
                 + (" stacked" if lead else ""))
        n_low, q, method = _codec_args(kname, cfg)
        nb = -(-k // cfg.w)
        if _refused(lambda: K.launch_contract(
                kname, m, k, nb, n, cfg.w, n_low, q, method, torch.float32,
                lead[0] if lead else 0, fields=_fields(kname, cfg, lead, nb, n),
                L=cfg.L, sms=sms),
                report, where):
            continue
        held.accept(kname)
        if dev.type != "cuda":
            continue
        wt = torch.randn(lead + (k, n), generator=gen)
        x = torch.randn(lead + (m, k), generator=gen)
        if grouped:
            f = _pack_leaf(wt, cfg)
            packed = PackedStruM(cfg.method, cfg.w, cfg.n_low, cfg.q, cfg.L, k,
                                 f["scale"], f["mask"], f["hi"], f["lo"])
            plain = lambda: ops.strum_grouped_matmul(  # noqa: E731
                x, packed, out_dtype=torch.float32,
                variant=kname.replace("grouped_", ""))
        else:
            packed = pack_array(wt, cfg)
            plain = (lambda: ops.strum_matmul_draft(  # noqa: E731
                x, packed, mode=mode, out_dtype=torch.float32)) if mode else \
                (lambda: ops.strum_matmul(x, packed, out_dtype=torch.float32,
                                          variant=kname))
        xd, pd = _to(x, dev), _to(packed, dev)
        got = _launched(lambda: variant.fn(xd, pd, out_dtype=torch.float32),
                        report, where)
        if got is not None:
            held.hold(kname, got, plain(), where, report)


def _lint_decode(variant, cfg, report, held, dev, gen) -> None:
    from repro_torch.engine.cache import _is_identity, encode_page

    page, feat, lead = 64, 32, 2
    info = LeafInfo(k_dim=page, n_out=feat, cache=True)
    if not variant.supports(cfg, info) or cfg is None or _is_identity(cfg) \
            or page % cfg.w:              # build_cache_spec refuses ragged pages
        return
    where = f"{variant.name} cfg={_cfg_str(cfg)} page={page} feat={feat}"
    if _refused(lambda: D.launch_contract(
            lead, page // cfg.w, cfg.w, feat, cfg.n_low, cfg.q, cfg.method,
            fields=_fields("page_decode", cfg, (lead,), page // cfg.w, feat)),
            report, where):
        return
    held.accept("page_decode")
    if dev.type != "cuda":
        return
    leaf = encode_page(torch.randn((lead, page, feat), generator=gen), cfg)
    leaf_d = _to(leaf, dev)
    got = _launched(lambda: variant.fn(leaf_d, cfg=cfg, page_size=page,
                                       out_dtype=torch.float32), report, where)
    if got is not None:
        held.hold("page_decode", got, variant.fn(leaf, cfg=cfg, page_size=page,
                                                 out_dtype=torch.float32),
                  where, report)


def _lint_attention(variant, kname, cfg, report, held, dev, sms, gen) -> None:
    from repro_torch.engine.cache import _is_identity, build_cache_spec, encode_page

    g = _ATTN
    for hd in HEAD_DIMS:
        for page in PAGE_SIZES:
            feat = g["kv"] * hd
            info = LeafInfo(k_dim=page, n_out=feat, cache=True, attn=True,
                            head_dim=hd)
            if not variant.supports(cfg, info):
                continue
            if cfg is None or _is_identity(cfg) or page % cfg.w:
                continue
            where = (f"{variant.name} cfg={_cfg_str(cfg)} page={page} "
                     f"head_dim={hd}")
            n_low, q, method = _codec_args(kname, cfg)
            if _refused(lambda: A.launch_contract(
                    kname, g["b"], g["kv"], g["r"], hd, g["pp"], g["n_pages"],
                    page // cfg.w, cfg.w, n_low, q, method, sms=sms,
                    fields=_fields(kname, cfg, (g["n_pages"],), page // cfg.w, feat)),
                    report, where):
                continue
            held.accept(kname)
            if dev.type != "cuda":
                continue
            pool = {kv: encode_page(torch.randn((g["n_pages"], page, feat),
                                                generator=gen), cfg)
                    for kv in ("k", "v")}
            qf = torch.randn((g["b"], g["kv"], g["r"], hd), generator=gen)
            table = torch.tensor([[0, 2, 1], [3, 1, -1]], dtype=torch.int32)
            n_valid = torch.tensor([3, 2], dtype=torch.int32)
            spec = build_cache_spec(cfg, page_size=page, feat=feat, device="cpu",
                                    head_dim=hd)
            args = (pool, qf, table, n_valid)
            dargs = tuple(_to(a, dev) for a in args)
            got = _launched(lambda: variant.fn(*dargs, cfg=cfg, spec=spec),
                            report, where)
            if got is not None:
                held.hold(kname, tuple(got), tuple(variant.fn(*args, cfg=cfg,
                                                              spec=spec)),
                          where, report)


def lint_block_contracts() -> Report:
    """Property-check the port's tiling helpers over an adversarial grid,
    each against its own written contract."""
    report = Report()

    def bad(where, detail):
        report.add("error", "pallas/block-contract", where, detail)

    grid = itertools.product((1, 3, 8, 16, 17, 128, 8192), (1, 64, 96, 257, 2048, 8192),
                             (1, 3, 4, 64, 512), (1, 8, 114, 132), (False, True))
    for m, n, nb, sms, bf16 in grid:
        # the template: clusters of at most MAX_SPLITS blocks, slices of >= 4
        # w-blocks wherever it splits
        s = K._splits(m, n, nb, sms=sms)
        if not (1 <= s <= K.MAX_SPLITS and (s == 1 or s <= nb // 4)):
            bad(f"_splits({m}, {n}, {nb}, sms={sms})",
                f"returned {s}; want 1, or <= min(MAX_SPLITS, nb // 4)")
        # the streamed kernel: the same, and no second partial wave
        s = K._stream_splits(m, n, nb, bf16, sms=sms)
        tiles = -(-n // K.STREAM_BN) * -(-m // (128 if bf16 and m > 16 else 16))
        if not (1 <= s <= K.MAX_SPLITS and (s == 1 or (s <= nb // 4
                                                        and tiles * s <= sms))):
            bad(f"_stream_splits({m}, {n}, {nb}, {bf16}, sms={sms})",
                f"returned {s}; want 1, or <= min(MAX_SPLITS, nb // 4) with "
                f"{tiles} tiles x splits <= {sms} SMs")
        # a launch takes its kernel's rule: streamed at w <= 64, w % 8 == 0
        for name, w in (("onehot", 16), ("onehot", 72), ("dense", 12)):
            want = K._stream_splits(m, n, nb, bf16, sms=sms) if K._streamed(name, w) \
                else K._splits(m, n, nb, sms=sms)
            got = K._split_count(name, m, n, nb, w, bf16, sms=sms)
            if got != want:
                bad(f"_split_count({name!r}, {m}, {n}, {nb}, {w})",
                    f"returned {got}; its kernel's rule gives {want}")
    for slots, pages, heads, sms in itertools.product(
            (1, 4, 64), (1, 3, 5, 31, 32, 33, 128, 1000), (1, 16, 128), (1, 132)):
        pps = A.split_pages(slots, pages, heads, sms)
        splits = -(-pages // pps)
        if not (1 <= pps <= A.MAX_SPLIT_PAGES
                and (splits - 1) * pps < pages <= splits * pps):
            bad(f"split_pages({slots}, {pages}, {heads}, {sms})",
                f"returned {pps}; want 1..{A.MAX_SPLIT_PAGES} page slots a split "
                f"and no empty split")
    for m, n_fsdp in itertools.product((1, 3, 8, 17, 64), (1, 2, 4, 8)):
        pad = _pick_m_pad(m, n_fsdp)
        ok = (pad == 0 if n_fsdp <= 1
              else (0 <= pad < n_fsdp and (m + pad) % n_fsdp == 0))
        if not ok:
            bad(f"_pick_m_pad({m}, {n_fsdp})",
                f"returned {pad}; want the minimal pad making M divide the FSDP "
                f"width")
    return report


# ------------------------------------------------ C++ refusals on the card --

def _code(call) -> Optional[int]:
    """Run one launch; the CUDA error it reports, 0 if it launched."""
    try:
        call()
    except RuntimeError as exc:
        msg = str(exc)
        if "CUDA error" not in msg:
            raise
        return int(msg.rsplit(" ", 1)[-1])
    return 0


def _skipping(module, route, call):
    """``call`` with ``module.launch_contract`` skipped: the launcher gets
    ``route`` and goes straight on to the C++ entry point."""
    def run():
        saved = module.launch_contract
        module.launch_contract = lambda *a, **k: dict(route)
        try:
            return _code(call)
        finally:
            module.launch_contract = saved
    return run


def _packed(dev, cfg, k, n, lead=(), gen=None):
    from repro_torch.core.packing import PackedStruM
    from repro_torch.models.quantize import _pack_leaf
    f = _pack_leaf(torch.randn(lead + (k, n), generator=gen), cfg)
    return PackedStruM(cfg.method, cfg.w, cfg.n_low, cfg.q, cfg.L, k,
                       *(f[x].to(dev) for x in ("scale", "mask", "hi", "lo")))


def _matmul_cases(dev, gen) -> list:
    c16 = StruMConfig(method="mip2q", w=16, p=0.5, L=5)
    c72 = StruMConfig(method="mip2q", w=72, p=0.5, L=5)
    d72 = StruMConfig(method="dliq", w=72, p=1.0, q=4)
    z72 = StruMConfig(method="mip2q", w=72, p=0.0, L=5)
    x, x72 = (torch.randn((4, k), generator=gen).to(dev) for k in (256, 288))
    xg = torch.randn((2, 4, 144), generator=gen).to(dev)
    p16, p72 = _packed(dev, c16, 256, 128, gen=gen), _packed(dev, c72, 288, 128, gen=gen)
    g72 = _packed(dev, c72, 144, 64, (2,), gen=gen)
    gd72 = _packed(dev, d72, 144, 64, (2,), gen=gen)
    gz72 = _packed(dev, z72, 144, 64, (2,), gen=gen)
    hi9 = torch.cat([p16.hi, p16.hi[:, :1]], dim=1).contiguous()
    words = K.byte_path_tables(16, 8, q=4, method="mip2q", L=5)
    r16 = {"nb": 16, "w": 16, "rows": (2, 8, 4), "tables": words,
           "splits": 1}
    r72 = {"nb": 4, "w": 72, "rows": (9, 36, 18), "tables": None,
           "splits": 1}

    def k1(xx, p, hi=None):
        return lambda: K.strum_matmul_onehot(xx, p.mask, p.hi if hi is None else hi,
                                             p.lo, p.scale, w=p.w, n_low=p.n_low,
                                             q=p.q, method=p.method, L=p.L)

    def k8_no_groups():         # G = 0 never passes the launcher's scale check
        fn = K._lib().strum_grouped_dense_launch
        out = torch.empty((2, 4, 64), device=dev)
        err = fn(xg.data_ptr(), 0, None, gz72.hi.data_ptr(), None, gz72.scale.data_ptr(),
                 None, out.data_ptr(), 0, 4, 64, 144, 2, 72, 0, 72, 0, 0, 1, 0, None,
                 torch.cuda.current_stream(dev).cuda_stream)
        if err:
            raise RuntimeError(f"cuda:grouped_dense launch failed: CUDA error {err}")

    f32 = torch.float32
    return [
        # the K split is the contract's own (lint_block_contracts holds it
        # in [1, MAX_SPLITS]): only the C++ side is probed
        ("K1 streamed, 9 K splits", 1744, None,
         _skipping(K, dict(r16, splits=9), k1(x, p16))),
        ("K1 template (w=72), 9 K splits", 442, None,
         _skipping(K, dict(r72, splits=9), k1(x72, p72))),
        ("K1 byte path, 9 hi rows", 1786,
         lambda: K.launch_contract("onehot", 4, 256, 16, 128, 16, 8, 4, "mip2q", f32,
                                   fields={"mask": ((16, 2, 128), torch.uint8),
                                           "hi": ((16, 9, 128), torch.int8),
                                           "lo": ((16, 4, 128), torch.uint8)}, L=5),
         _skipping(K, dict(r16, rows=(2, 9, 4)), k1(x, p16, hi9))),
        ("K6 at w=72", 1860,
         lambda: K.launch_contract("grouped_onehot", 4, 144, 2, 64, 72, 36, 4,
                                   "mip2q", f32, 2),
         _skipping(K, dict(r72, nb=2), lambda: K.strum_matmul_grouped_onehot(
             xg, g72.mask, g72.hi, g72.lo, g72.scale, w=72, n_low=36, q=4,
             method="mip2q"))),
        ("K7 at w=72", 1886,
         lambda: K.launch_contract("grouped_maskfree", 4, 144, 2, 64, 72, 72, 4,
                                   "dliq", f32, 2),
         _skipping(K, dict(r72, nb=2, rows=(0, 0, 36)),
                   lambda: K.strum_matmul_grouped_maskfree(
                       xg, gd72.lo, gd72.scale, w=72, q=4, method="dliq"))),
        ("K8 with no groups", 1838,
         lambda: K.launch_contract("grouped_dense", 4, 144, 2, 64, 72, 0, 1,
                                   "sparsity", f32, 0),
         lambda: _code(k8_no_groups)),
    ]


def _attention_cases(dev, gen) -> list:
    from repro_torch.engine.cache import encode_page
    mip7 = StruMConfig(method="mip2q", w=16, p=0.5, L=7)
    dl = StruMConfig(method="dliq", w=16, p=1.0, q=4)

    def k4(cfg, b, hd, maskfree=False, lo_rows=None):
        pools = {kv: _to(encode_page(torch.randn((2, 16, 2 * hd), generator=gen),
                                     cfg), dev) for kv in ("k", "v")}
        if lo_rows is not None:
            for pool in pools.values():
                pool["lo"] = pool["lo"][:, :, :lo_rows].contiguous()
        q4 = torch.zeros((b, 2, 1, hd), device=dev)
        table = torch.zeros((b, 1), dtype=torch.int32, device=dev)
        nv = torch.ones((b,), dtype=torch.int32, device=dev)
        k, v = pools["k"], pools["v"]
        if maskfree:
            return lambda: A.strum_paged_attention_maskfree(
                q4, k["lo"], k["scale"], v["lo"], v["scale"], table, nv, w=16, q=4,
                method="dliq")
        return lambda: A.strum_paged_attention(
            q4, k["mask"], k["hi"], k["lo"], k["scale"], v["mask"], v["hi"], v["lo"],
            v["scale"], table, nv, w=16, n_low=8, q=4, method="mip2q")

    one = {"pps": 1, "splits": 1, "rows": (2, 8, 4)}
    lo7 = {"lo": ((2, 1, 7, 128), torch.uint8)}

    def k11_w12():              # the wrapper refuses w % 8 before its contract
        f = torch.zeros((2, 1, 8, 8), dtype=torch.uint8, device=dev)
        scale, out = torch.ones((2, 1, 8), device=dev), torch.empty((2, 12, 8), device=dev)
        err = D.lib().strum_page_decode_launch(
            f.data_ptr(), f.data_ptr(), f.data_ptr(), scale.data_ptr(), out.data_ptr(),
            2, 1, 12, 8, 2, 6, 3, 6, 4, 1, torch.cuda.current_stream(dev).cuda_stream)
        if err:
            raise RuntimeError(f"cuda:page_decode launch failed: CUDA error {err}")

    return [
        ("K4 at head dim 288", 868,
         lambda: A.launch_contract("paged_attention", 2, 2, 1, 288, 1, 2, 1, 16, 8, 4,
                                   "mip2q"),
         _skipping(A, one, k4(mip7, 2, 288))),
        ("K5 with 7 lo rows", 873,
         lambda: A.launch_contract("paged_attention_maskfree", 2, 2, 1, 64, 1, 2, 1,
                                   16, 16, 4, "dliq", fields=lo7),
         _skipping(A, dict(one, rows=(0, 0, 7)), k4(dl, 2, 64, True, lo_rows=7))),
        ("K4 over 65535 slots", 882,
         lambda: A.launch_contract("paged_attention", 65536, 2, 1, 64, 1, 2, 1, 16, 8,
                                   4, "mip2q"),
         _skipping(A, one, k4(mip7, 65536, 64))),
        ("K11 at w=12", 918,
         lambda: D.launch_contract(2, 1, 12, 8, 6, 4, "dliq"),
         lambda: _code(k11_w12)),
    ]


def cxx_refusals(device="cuda") -> tuple:
    """Hand points each contract refuses for a C++ check straight to the C++
    entry point (the contract skipped): every call must come back
    ``cudaErrorInvalidValue`` (1) and launch nothing.  Returns ``(Report,
    [(probe, .cu line, CUDA error), ...])``."""
    report, seen = Report(), []
    dev = torch.device(device)
    gen = torch.Generator().manual_seed(0)
    for where, line, check, run in _matmul_cases(dev, gen) + _attention_cases(dev, gen):
        if check is not None:
            try:
                check()
                report.add("error", "pallas/tile-misaligned", where,
                           f"the launch contract accepts a point the C++ entry "
                           f"point refuses (line {line})")
            except ValueError as exc:
                if f":{line})" not in str(exc):
                    report.add("error", "pallas/tile-misaligned", where,
                               f"the contract refuses it without naming line "
                               f"{line}: {exc}")
        before = _counts()
        code = run()
        torch.cuda.synchronize()
        seen.append((where, line, code))
        if code != 1 or _counts() != before:
            report.add("error", "pallas/abstract-eval", where,
                       f"the C++ entry point (line {line}) gave {code}, not "
                       f"cudaErrorInvalidValue (1), or launched")
    return report, seen


def lint_pallas(cfgs: Optional[list] = None, variants: Optional[list] = None,
                device="cpu", stats: Optional[dict] = None) -> Report:
    """Sweep every ``cuda``-family variant with a launcher (matmul, draft,
    page decode, fused attention) against its launch contract, plus the
    block-contract properties.  ``variants`` narrows the sweep to the named
    variants (the seeded-defect tests lint exactly their planted
    registration).  With ``device="cuda"`` every accepted point is launched
    and held to its plain version, and the C++ refusals are probed;
    ``stats``, if given, receives the tallies (accepted points, launches
    and the worst error per kernel, the refusals)."""
    cfgs = default_lint_cfgs() if cfgs is None else cfgs
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    if on_card and not torch.cuda.is_available():
        raise RuntimeError("lint_pallas(device='cuda') needs a CUDA card")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count if on_card \
        else 132
    report = lint_block_contracts() if variants is None else Report()
    held, gen = _Held(), torch.Generator().manual_seed(0)
    before = _counts()
    for name, variant in sorted(list_variants().items()):
        if variants is not None and name not in variants:
            continue
        if variant.family != "cuda" or variant.sharded:
            continue
        kname = VARIANT_KERNELS.get(name)
        if kname is None:
            report.add("warning", "pallas/abstract-eval", name,
                       "a cuda-family variant with no known launcher: its "
                       "predicate is not held to a launch contract")
        elif variant.attn:
            for cfg in list(cfgs) + [None]:
                _lint_attention(variant, kname, cfg, report, held, dev, sms, gen)
        elif variant.cache:
            for cfg in list(cfgs) + [None]:
                _lint_decode(variant, cfg, report, held, dev, gen)
        else:
            for cfg in cfgs:
                _lint_matmul(variant, kname, cfg, report, held, dev, sms, gen)
    after = _counts()
    refusals = []
    if on_card and variants is None:
        r, refusals = cxx_refusals(dev)
        report.extend(r)
    if stats is not None:
        stats.update(points=held.points, worst=held.err, refusals=refusals,
                     launches={k: after[k] - before[k] for k in after
                               if after[k] != before[k]})
    return report
