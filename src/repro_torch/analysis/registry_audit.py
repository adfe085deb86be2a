"""Registry audit: sweeps the capability predicates of
``repro_torch.engine.registry`` and proves every variant earns its
registration (twin of ``repro.analysis.registry_audit``).

Selection is a pure function of ``(cfg, LeafInfo, backend)``, so the pass
runs the port's real :func:`repro_torch.engine.registry.select_variant` at
every point of the reference's grid of StruM configs x leaf contexts x
backends, with the backends mapped across (``pallas`` -> ``cuda``, ``xla``
-> ``torch``, ``reference`` -> ``reference``), and reports:

``registry/no-variant``            a grid point no variant supports;
``registry/unreachable-variant``   a predicate that accepts no grid point;
``registry/shadowed-variant``      a variant that accepts points but wins
                                   none;
``registry/priority-overlap``      two same-priority variants in one
                                   family/partition both accept a point;
``registry/coverage-hole``         an explicitly requested family falls
                                   back to another (the dequant fallback),
                                   aggregated per ``(method, w)`` class.

The attention contexts carry a head dim, so the fused kernels' limits
(``cache:attn_fused*``: head dim <= 256, w <= 64) are inside the grid:
``attn`` at head dim 128 and ``attn-hd320``, a context the reference has
no twin of, past the limit.  The same sweep yields the coverage table the
README embeds (:func:`render_coverage`).
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Optional

from repro_torch.analysis.report import Report
from repro_torch.core.policy import StruMConfig
from repro_torch.engine import plan as _plan  # noqa: F401  (registers every variant)
from repro_torch.engine.registry import (LeafInfo, list_variants, resolve_backend,
                                         select_variant)

__all__ = ["audit_registry", "default_grid", "render_coverage", "AuditData",
           "CONTEXTS", "BACKENDS", "BACKEND_NAMES"]

#: the probe geometry: K x N for matmul contexts, page_size x F for cache
_K, _N, _PAGE, _FEAT = 256, 512, 64, 128

CONTEXTS = (
    ("2d", LeafInfo(k_dim=_K, n_out=_N)),
    ("stacked", LeafInfo(k_dim=_K, n_out=_N, lead=(4,))),
    ("sharded-col", LeafInfo(k_dim=_K, n_out=_N, fsdp=("data",),
                             tp_pattern="col")),
    ("sharded-row", LeafInfo(k_dim=_K, n_out=_N, fsdp=("data",),
                             tp_pattern="row")),
    ("sharded-stacked", LeafInfo(k_dim=_K, n_out=_N, lead=(4,),
                                 fsdp=("data",))),
    ("cache", LeafInfo(k_dim=_PAGE, n_out=_FEAT, cache=True)),
    ("attn", LeafInfo(k_dim=_PAGE, n_out=_FEAT, cache=True, attn=True,
                      head_dim=128)),
    ("attn-hd320", LeafInfo(k_dim=_PAGE, n_out=_FEAT, cache=True, attn=True,
                            head_dim=320)),
    ("draft-histream", LeafInfo(k_dim=_K, n_out=_N, draft="histream")),
    ("draft-maskfree_p", LeafInfo(k_dim=_K, n_out=_N, draft="maskfree_p")),
)

BACKENDS = ("cuda", "torch", "reference")
#: the port's backend -> the reference's
BACKEND_NAMES = {"cuda": "pallas", "torch": "xla", "reference": "reference"}


def default_grid() -> list:
    """Representative ``method x w x p x q/L`` configs (invalid ``(p, w)``
    combinations — fractional ``n_low`` — are skipped, as the policy layer
    would reject them)."""
    cfgs = []
    for w in (4, 8, 16, 32):
        for p in (0.0, 0.25, 0.5, 0.75, 1.0):
            for method, extras in (("sparsity", ({},)),
                                   ("dliq", ({"q": 2}, {"q": 4}, {"q": 8})),
                                   ("mip2q", ({"L": 2}, {"L": 5}))):
                for extra in extras:
                    try:
                        cfgs.append(StruMConfig(method=method, w=w, p=p,
                                                **extra))
                    except ValueError:
                        continue
    # cache contexts additionally see "no codec" (fp passthrough)
    return cfgs


@dataclasses.dataclass
class AuditData:
    """Raw sweep results backing both the findings and the coverage table."""

    n_points: int
    selected: dict               # variant name -> points won
    supported: dict              # variant name -> points accepted
    contexts_won: dict           # variant name -> set of context names
    holes: dict                  # (backend, method, w) -> count
    overlaps: set                # ((name_a, name_b), context, priority)
    winners: dict = dataclasses.field(default_factory=dict)
    # (context, cfg, backend) -> winning variant name (None: no variant)


def _partition_matches(variant, info: LeafInfo) -> bool:
    return (variant.sharded == bool(info.fsdp)
            and variant.cache == bool(info.cache)
            and variant.attn == bool(info.attn)
            and variant.draft == bool(info.draft))


def audit_registry(cfgs: Optional[list] = None) -> tuple:
    """Sweep the grid; returns ``(Report, AuditData)``."""
    cfgs = default_grid() if cfgs is None else cfgs
    registry = list_variants()
    selected = {name: 0 for name in registry}
    supported = {name: 0 for name in registry}
    contexts_won: dict = {name: set() for name in registry}
    holes: dict = {}
    overlaps: set = set()
    winners: dict = {}
    report = Report()
    n_points = 0

    for ctx_name, info in CONTEXTS:
        ctx_cfgs = list(cfgs) + ([None] if info.cache else [])
        for cfg in ctx_cfgs:
            # reachability / overlap bookkeeping straight off the predicates
            accepting = [v for v in registry.values()
                         if _partition_matches(v, info)
                         and v.supports(cfg, info)]
            for v in accepting:
                supported[v.name] += 1
            by_prio: dict = {}
            for v in accepting:
                by_prio.setdefault((v.family, v.priority), []).append(v.name)
            for (_family, prio), names in by_prio.items():
                if len(names) > 1:
                    overlaps.add((tuple(sorted(names)), ctx_name, prio))

            for backend in BACKENDS:
                n_points += 1
                fam = resolve_backend(backend)
                try:
                    with warnings.catch_warnings():
                        warnings.simplefilter("ignore")
                        winner = select_variant(cfg, info, backend=backend)
                except LookupError:
                    winners[(ctx_name, cfg, backend)] = None
                    if info.draft:
                        # draft selection holes are by design:
                        # build_draft_plan keeps such leaves at full
                        # fidelity, so the draft is exact there, never wrong
                        continue
                    report.add(
                        "error", "registry/no-variant",
                        f"{ctx_name} backend={backend}",
                        f"no variant supports cfg={cfg} — every config the "
                        f"policy layer can emit needs a lowering")
                    continue
                winners[(ctx_name, cfg, backend)] = winner.name
                selected[winner.name] += 1
                contexts_won[winner.name].add(ctx_name)
                if winner.family != fam and not winner.redispatch \
                        and cfg is not None:
                    key = (backend, cfg.method, cfg.w)
                    holes[key] = holes.get(key, 0) + 1

    for name in registry:
        if selected[name]:
            continue
        if supported[name] == 0:
            report.add("warning", "registry/unreachable-variant", name,
                       "predicate accepts no point of the capability grid "
                       "(dead predicate, or the grid needs a new axis)")
        else:
            report.add("error", "registry/shadowed-variant", name,
                       f"accepts {supported[name]} grid point(s) but wins "
                       f"none — a higher-(priority, name) variant covers "
                       f"its entire footprint")

    for names, ctx_name, prio in sorted(overlaps):
        report.add("warning", "registry/priority-overlap",
                   f"{ctx_name} priority={prio}",
                   f"{' vs '.join(names)} both accept a grid point at the "
                   f"same priority; selection falls back to name order")

    for (backend, method, w), count in sorted(holes.items()):
        report.add("info", "registry/coverage-hole",
                   f"backend={backend} method={method} w={w}",
                   f"{count} grid point(s) fall back to the dequant family "
                   f"(expected for non-byte-aligned w on the cuda path)")

    data = AuditData(n_points=n_points, selected=selected,
                     supported=supported, contexts_won=contexts_won,
                     holes=holes, overlaps=overlaps, winners=winners)
    return report, data


def render_coverage(data: AuditData) -> str:
    """Markdown coverage table (embedded in README's port section): one row
    per registered variant."""
    registry = list_variants()
    lines = [
        "| variant | family | priority | contexts won | grid points won |",
        "|---|---|---:|---|---:|",
    ]
    for name in sorted(registry):
        v = registry[name]
        ctxs = ", ".join(sorted(data.contexts_won.get(name, ()))) or "—"
        won = data.selected.get(name, 0)
        share = 100.0 * won / max(data.n_points, 1)
        lines.append(f"| `{name}` | {v.family} | {v.priority} | {ctxs} "
                     f"| {won} ({share:.1f}%) |")
    return "\n".join(lines)
