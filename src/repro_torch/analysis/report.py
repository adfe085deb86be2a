"""Findings and reports: the one output format every pass of
``repro_torch.analysis`` emits (twin of ``repro.analysis.report``).

The port's own copy.  The rule ids are the reference's letter for letter,
so the two packages' reports compare id for id, and for the same findings
``Report.to_json`` gives the same JSON.  Where the port gives a rule
another meaning (the ``pallas/*`` rules are the CUDA launchers' contract,
``recompile/lane-retrace`` a lane's shape signature, the dataflow rules
are read off a recorded eager run), its text says so.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Iterable, Optional

__all__ = ["Finding", "Report", "RULES", "SEVERITIES"]

SEVERITIES: tuple[str, ...] = ("error", "warning", "info")

#: rule id -> one-line description (the README glossary is generated from
#: this table, so a rule cannot ship without documentation)
RULES: dict[str, str] = {
    "dataflow/fp-collective":
        "a gather-class collective (all_gather/all_to_all/ppermute) moves "
        "decoded floating-point bytes instead of packed payload bytes",
    "dataflow/eq1-bytes":
        "the packed bytes a collective moves disagree with the Eq.-1/2 "
        "prediction (K x N x compression_ratio) for the leaf",
    "dataflow/decode-multiplicity":
        "one payload leaf is decoded in more than one program region — the "
        "fp intermediate is re-materialized instead of decoded exactly once "
        "(port: a leaf's field read by more than one decode site, a kernel "
        "call or the first op turning its bytes into floats, in one traced "
        "call)",
    "dataflow/fp-page":
        "a paged lane claiming the Eq.-1 cache read gathers raw fp pages or "
        "re-gathers pool bytes after decoding them — sealed pools must "
        "leave HBM as mask+hi+lo bytes only",
    "attn/unfused-lane":
        "a packed-codec scheduler lane did not select the fused attention "
        "variant (cache:attn_fused*) — the decode hot loop falls back to "
        "gather-then-einsum and loses the Eq.-1 HBM ratio",
    "cache/fp-page":
        "a packed cache pool stores a floating-point payload field — fp "
        "bytes leak out of sealed pages",
    "registry/no-variant":
        "no registered kernel variant supports a (config, context) point of "
        "the capability grid",
    "registry/unreachable-variant":
        "a registered variant's predicate accepts no point of the "
        "capability grid (dead predicate or grid hole)",
    "registry/shadowed-variant":
        "a variant is never selected: everywhere its predicate accepts, a "
        "higher-(priority, name) variant in the same partition also accepts",
    "registry/priority-overlap":
        "two variants in the same family/partition share a priority and "
        "both accept some grid point — selection falls back to name order",
    "registry/coverage-hole":
        "a requested pallas backend falls through to the xla family "
        "(dequant fallback) for a grid point",
    "pallas/tile-misaligned":
        "a Pallas lowering's tile/grid contract (block alignment, "
        "divisibility) rejects a config its registry predicate accepts "
        "(port: the CUDA launcher's launch_contract refuses it)",
    "pallas/abstract-eval":
        "abstract evaluation (trace, no execution) of a Pallas variant "
        "failed (port: a launch of a point its contract accepts raised on "
        "the card, or a C++ entry point launched a point the contract "
        "refuses)",
    "pallas/output-mismatch":
        "a variant's traced output shape/dtype disagrees with the dispatch "
        "contract (M, N) in the requested dtype (port: or a launch's output "
        "is outside tolerance of its kernel's plain version)",
    "pallas/block-contract":
        "ops._pick_block / sharded._pick_m_pad violated their alignment "
        "contract for some (dim, pref, align) point (port: the tiling "
        "helpers strum_matmul._splits / _stream_splits / _split_count, "
        "strum_attention.split_pages and sharded._pick_m_pad)",
    "recompile/lane-retrace":
        "a scheduler lane executable compiled more than once across a "
        "mixed-length workload — the PR-5 fixed-shape invariant regressed "
        "(port: a lane's calls show more than one shape signature, the "
        "ordered ops and launches with their input shapes and dtypes, which "
        "CUDA-graph capture of the lane needs to be one)",
    "plan/selection-drift":
        "re-running variant selection for a plan entry under its recorded "
        "backend picks a different variant than the plan recorded",
    "plan/payload-shape":
        "a plan entry's packed payload field shapes disagree with "
        "packing.field_dims for its config",
    "plan/k-dim":
        "a plan entry's recorded reduction dim disagrees with its payload "
        "geometry",
    "numerics/budget-exceeded":
        "a statically derived output-error bound (end-to-end or per-layer) "
        "exceeds the schedule's declared error budget",
    "numerics/unsound-bound":
        "the static output-error bound is beaten by measured teacher-forced "
        "error — the abstract interpreter itself is wrong (soundness "
        "self-check)",
    "numerics/unsupported-op":
        "the numerics interpreter met a primitive it cannot transfer "
        "through; downstream bounds fall back to unconstrained",
    "numerics/unbounded":
        "an operation (division by a zero-spanning interval, rsqrt of a "
        "non-positive range) made the static bound unconstrained",
    "draft/extra-bytes":
        "a draft plan's payload is not byte-identical to the target plan's "
        "— a drafted leaf's mask/hi/lo/scale arrays must be the SAME "
        "buffers (zero additional weight bytes in HBM)",
    "draft/stream-read":
        "the traced draft decode step reads a payload stream its draft "
        "mode declares skipped (e.g. histream touching lo) — the skipped "
        "stream must stay a dead jaxpr input (port: no op or kernel call "
        "of the traced step is handed it)",
    "draft/no-subset":
        "the draft lane's live payload bytes are not a strict subset of "
        "the full-fidelity lane's — drafting would read at least as many "
        "weight bytes as plain decode",
}


@dataclasses.dataclass(frozen=True)
class Finding:
    """One analysis result: ``severity`` in {error, warning, info}."""

    severity: str
    rule: str
    location: str
    detail: str

    def __post_init__(self) -> None:
        if self.severity not in SEVERITIES:
            raise ValueError(f"severity {self.severity!r} not in {SEVERITIES}")
        if self.rule not in RULES:
            raise ValueError(f"unknown rule {self.rule!r}; add it to "
                             f"analysis.report.RULES")

    def render(self) -> str:
        return f"[{self.severity}] {self.rule} @ {self.location}: {self.detail}"


@dataclasses.dataclass
class Report:
    """An ordered collection of findings with severity accessors."""

    findings: list[Finding] = dataclasses.field(default_factory=list)

    def add(self, severity: str, rule: str, location: str, detail: str) -> None:
        self.findings.append(Finding(severity, rule, location, detail))

    def extend(self, other: "Report") -> "Report":
        self.findings.extend(other.findings)
        return self

    def errors(self) -> list[Finding]:
        return [f for f in self.findings if f.severity == "error"]

    def warnings(self) -> list[Finding]:
        return [f for f in self.findings if f.severity == "warning"]

    def by_rule(self, rule: str) -> list[Finding]:
        return [f for f in self.findings if f.rule == rule]

    @property
    def ok(self) -> bool:
        return not self.errors()

    def to_json(self) -> dict[str, object]:
        counts = {s: 0 for s in SEVERITIES}
        for f in self.findings:
            counts[f.severity] += 1
        return {"counts": counts,
                "findings": [dataclasses.asdict(f) for f in self.findings]}

    def render(self, min_severity: str = "info") -> str:
        keep = SEVERITIES[:SEVERITIES.index(min_severity) + 1]
        lines = [f.render() for f in self.findings if f.severity in keep]
        c = {s: 0 for s in SEVERITIES}
        for f in self.findings:
            c[f.severity] += 1
        lines.append(f"{c['error']} error(s), {c['warning']} warning(s), "
                     f"{c['info']} info")
        return "\n".join(lines)

    def dumps(self, indent: Optional[int] = 1) -> str:
        return json.dumps(self.to_json(), indent=indent)

    @staticmethod
    def merged(reports: Iterable["Report"]) -> "Report":
        out = Report()
        for r in reports:
            out.extend(r)
        return out
