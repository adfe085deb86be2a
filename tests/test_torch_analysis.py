"""The port's static analysis (``repro_torch.analysis``) against the
reference's (``repro.analysis``) on the CPU.

* findings and rules: the same 26 rule ids, the same JSON for the same
  findings;
* the registry audit picks the reference's winner at every point of the
  reference's grid under the family map (``pallas`` -> ``cuda``, ``xla`` ->
  ``torch``); the one context the port adds (``attn-hd320``, past the
  fused kernels' head-dim limit) is listed with its reason;
* the seeded defects of ``tests/test_analysis.py``, rebuilt on the port's
  registry, give the reference's rule ids; F1 and F3 re-planted are
  flagged by the launch-contract lint;
* plan validation gives the reference's findings on a clean and a
  corrupted plan, reads a mesh-aware plan's blocks, and
  ``per_tensor_bound`` is within 1e-6 of the reference's on every leaf;
* the CLI: exit codes, ``--json``, ``--list-rules``, ``--check-docs``.
"""
import dataclasses
import json
import subprocess
import sys
import warnings
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.analysis import registry_audit as j_audit
from repro.analysis.report import RULES as J_RULES
from repro.analysis.report import SEVERITIES as J_SEVERITIES
from repro.analysis.report import Report as JReport
from repro.core.policy import StruMConfig as JCfg
from repro.engine.registry import select_variant as j_select
from repro_torch import engine
from repro_torch.analysis import (RULES, SEVERITIES, Finding, Report, audit_registry,
                                  lint_pallas, render_coverage, validate_plan)
from repro_torch.analysis import pallas_lint, registry_audit
from repro_torch.core.policy import StruMConfig
from repro_torch.engine import registry as reg

torch.set_num_threads(1)  # xdist runs several workers side by side: one intra-op thread each

ROOT = Path(__file__).resolve().parents[1]
CFG = StruMConfig(method="mip2q", w=16, p=0.5, L=5)


def port_name(name):
    """The reference's variant name under the port's family map."""
    if name is None:
        return None
    fam, rest = name.split(":", 1)
    if fam in ("pallas", "xla"):
        return f"{ {'pallas': 'cuda', 'xla': 'torch'}[fam]}:{rest}"
    return {"ref:jnp": "ref:torch", "cache:pallas_decode": "cache:cuda_decode",
            "cache:xla_dequant": "cache:torch_dequant",
            "draft:xla_histream": "draft:torch_histream",
            "draft:xla_maskfree_p": "draft:torch_maskfree_p"}.get(name, name)


# ----------------------------------------------------------------- report --

def test_rules_and_severities_are_the_references():
    assert list(RULES) == list(J_RULES) and len(RULES) == 26
    assert SEVERITIES == J_SEVERITIES
    with pytest.raises(ValueError):
        Finding("error", "not/a-rule", "x", "y")
    with pytest.raises(ValueError):
        Finding("fatal", "dataflow/eq1-bytes", "x", "y")


def test_report_json_equals_the_references():
    findings = [("error", "dataflow/eq1-bytes", "a", "d1"),
                ("warning", "registry/priority-overlap", "b", "d2"),
                ("info", "registry/coverage-hole", "c", "d3")]
    r, j = Report(), JReport()
    for f in findings:
        r.add(*f)
        j.add(*f)
    assert r.dumps() == j.dumps() and r.render("info") == j.render("info")
    assert not r.ok and len(r.errors()) == 1 and len(r.warnings()) == 1
    assert len(r.by_rule("dataflow/eq1-bytes")) == 1
    assert Report.merged([r, r]).to_json()["counts"] == {"error": 2, "warning": 2,
                                                          "info": 2}


# ---------------------------------------------------------- registry audit --

@pytest.fixture(scope="module")
def audit():
    return audit_registry()


def _reference_winner(ctx, cfg, backend):
    jcfg = None if cfg is None else JCfg(method=cfg.method, w=cfg.w, p=cfg.p, q=cfg.q,
                                         L=cfg.L)
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            return j_select(jcfg, dict(j_audit.CONTEXTS)[ctx],
                            backend=registry_audit.BACKEND_NAMES[backend]).name
    except LookupError:
        return None


def test_audit_picks_the_references_winner_at_every_grid_point(audit):
    """Every (context, config, backend) point of the reference's grid, under
    the family map; the grids and contexts are the reference's."""
    _, data = audit
    assert [c for c, _ in j_audit.CONTEXTS] == \
        [c for c, _ in registry_audit.CONTEXTS if c != "attn-hd320"]
    assert [dataclasses.astuple(c) for c in registry_audit.default_grid()] == \
        [(c.method, c.w, c.p, c.q, c.L) for c in j_audit.default_grid()]
    shared = {k: v for k, v in data.winners.items() if k[0] != "attn-hd320"}
    assert len(shared) == 9 * 3 * len(j_audit.default_grid()) + 2 * 3
    diffs = [(k, v, _reference_winner(*k)) for k, v in shared.items()
             if v != port_name(_reference_winner(*k))]
    assert not diffs, diffs[:5]


def test_attn_context_past_the_head_dim_limit_differs_by_design(audit):
    """F1's limit: at head dim 320 the port's fused consumers (K4, K5: at
    most 256) give way to ``cache:attn_unfused``; the reference's attention
    context has no head dim, so it keeps its fused pick there.  Every other
    point agrees."""
    _, data = audit
    diffs = {}
    for (ctx, cfg, backend), got in data.winners.items():
        if ctx == "attn-hd320":
            want = port_name(_reference_winner("attn", cfg, backend))
            if got != want:
                diffs.setdefault((want, got), 0)
                diffs[(want, got)] += 1
    assert set(diffs) == {("cache:attn_fused", "cache:attn_unfused"),
                          ("cache:attn_fused_maskfree", "cache:attn_unfused")}, diffs


def test_registry_audit_clean(audit):
    report, data = audit
    assert report.ok and not report.warnings(), report.render()
    for name in reg.list_variants():
        assert data.selected[name] > 0, name
    table = render_coverage(data)
    for name in reg.list_variants():
        assert f"`{name}`" in table


def test_coverage_holes_equal_the_references(audit):
    report, _ = audit
    j_report, _ = j_audit.audit_registry()
    got = [(f.location.replace("backend=cuda", "backend=pallas"), f.detail.split(" ")[0])
           for f in report.by_rule("registry/coverage-hole")
           if not f.location.startswith("backend=reference")]
    want = [(f.location, f.detail.split(" ")[0])
            for f in j_report.by_rule("registry/coverage-hole")
            if not f.location.startswith("backend=reference")]
    assert sorted(got) == sorted(want)


# -------------------------------------------------------- seeded defects --

def test_seeded_shadowed_variant():
    def supports_dense(cfg, info):
        return (cfg is not None and info.lead == () and not info.cache
                and cfg.n_low == 0)
    try:
        reg.register_kernel("test:always_shadowed", family="cuda", priority=1,
                            supports=supports_dense)(lambda *a, **k: None)
        report, _ = audit_registry()
        hits = report.by_rule("registry/shadowed-variant")
        assert [f for f in hits if "test:always_shadowed" in f.location], report.render()
    finally:
        reg.unregister_kernel("test:always_shadowed")
    report, _ = audit_registry()
    assert report.ok and not report.warnings(), report.render()


def test_seeded_priority_overlap():
    def supports_all_2d(cfg, info):
        return cfg is not None and info.lead == () and not info.cache
    try:
        reg.register_kernel("test:overlaps_dequant", family="torch", priority=0,
                            supports=supports_all_2d)(lambda *a, **k: None)
        report, _ = audit_registry()
        hits = report.by_rule("registry/priority-overlap")
        assert [f for f in hits if "test:overlaps_dequant" in f.detail], report.render()
    finally:
        reg.unregister_kernel("test:overlaps_dequant")


@pytest.fixture
def replant():
    """Re-register a variant with another predicate for one test, then
    restore the original registration."""
    saved = {}

    def plant(name, supports):
        v = reg.get_variant(name)
        saved.setdefault(name, v)
        reg._REGISTRY[name] = dataclasses.replace(v, supports=supports)
    yield plant
    reg._REGISTRY.update(saved)


def test_launch_contract_lint_clean():
    report = lint_pallas()
    assert report.ok and not report.findings, report.render()
    wide = [StruMConfig(method="mip2q", w=w, p=0.5, L=5) for w in (72, 128)]
    assert lint_pallas(cfgs=wide, variants=list(pallas_lint.VARIANT_KERNELS)).ok


@pytest.mark.parametrize("name,supports,cfg", [
    # the port's form of the reference's misaligned tile: K2's predicate
    # without its n_low == w condition
    ("cuda:maskfree", lambda cfg, info: not info.lead and cfg.method != "sparsity",
     StruMConfig(method="dliq", w=16, p=0.5, q=4)),
    # F3: cuda:grouped (K6) past w = 64
    ("cuda:grouped", lambda cfg, info: bool(info.lead) and cfg.w % 8 == 0,
     StruMConfig(method="mip2q", w=72, p=0.5, L=5)),
    # F1: cache:attn_fused (K4) past w = 64 (and past head dim 256)
    ("cache:attn_fused", lambda cfg, info: cfg is not None and cfg.q < 8
     and cfg.w % 8 == 0, StruMConfig(method="mip2q", w=128, p=0.5, L=5))],
    ids=["misaligned", "F3", "F1"])
def test_seeded_launch_contract_faults_are_flagged(replant, name, supports, cfg):
    replant(name, supports)
    report = lint_pallas(cfgs=[cfg], variants=[name])
    hits = report.by_rule("pallas/tile-misaligned")
    assert hits and all(f.severity == "error" for f in hits), report.render()
    assert not report.ok


def test_block_contracts_hold_and_catch_a_broken_helper(monkeypatch):
    assert not pallas_lint.lint_block_contracts().findings
    from repro_torch.kernels import strum_matmul as K
    # a split past the portable cluster of MAX_SPLITS blocks
    monkeypatch.setattr(K, "_stream_splits", lambda *a, **k: K.MAX_SPLITS + 1)
    broken = pallas_lint.lint_block_contracts()
    assert broken.by_rule("pallas/block-contract")


# --------------------------------------------------------- plan validation --

def _wq_params(xp):
    return {"blocks": {"pos0": {"attn": {"wq": {"w": xp.zeros((64, 128),
                                                               dtype=xp.float32)}}}}}


def test_validate_plan_findings_equal_the_references():
    from repro import engine as jengine
    from repro.analysis import validate_plan as j_validate
    from repro.engine.plan import _maybe_validate as j_maybe
    from repro_torch.engine.plan import _maybe_validate

    jplan = jengine.build_plan(_wq_params(np), cfg=JCfg(method="mip2q", w=16, p=0.5, L=5))
    tplan = engine.build_plan(_wq_params(torch), cfg=CFG, device="cpu")
    assert not validate_plan(tplan).findings and not j_validate(jplan).findings
    name = "blocks/pos0/attn/wq/w"
    jplan.entries[name].leaf["hi"] = jplan.entries[name].leaf["hi"].astype(jnp.int32)
    tplan.entries[name].leaf["hi"] = tplan.entries[name].leaf["hi"].to(torch.int32)
    got, want = validate_plan(tplan), j_validate(jplan)
    assert got.by_rule("plan/payload-shape") and got.to_json() == want.to_json()
    # a field cut short: shape findings, as the reference's
    jplan.entries[name].leaf["lo"] = jplan.entries[name].leaf["lo"][:, :2]
    tplan.entries[name].leaf["lo"] = tplan.entries[name].leaf["lo"][:, :2]
    assert validate_plan(tplan).to_json() == j_validate(jplan).to_json()
    with pytest.raises(ValueError, match="validate=True"):
        _maybe_validate(tplan, True, None, "cpu")
    with pytest.raises(ValueError, match="validate=True"):
        j_maybe(jplan, validate=True)


def test_build_plan_validate_hook():
    plan = engine.build_plan(_wq_params(torch), cfg=CFG, validate=True, device="cpu")
    assert plan.entries


def test_selection_drift_is_flagged():
    plan = engine.build_plan(_wq_params(torch), cfg=CFG, device="cpu")
    plan.entries["blocks/pos0/attn/wq/w"].variant = "cuda:onehot"
    assert validate_plan(plan).by_rule("plan/selection-drift")


class FakeMesh:
    """A mesh-like object for shard_slice: rank 0 of a data x model mesh
    (no process group)."""

    def __init__(self, **shape):
        self.axis_names = tuple(shape)
        self.shape = dict(shape)

    def size(self, i):
        return list(self.shape.values())[i]

    def get_local_rank(self, axis):
        return 0


def test_validate_plan_reads_a_mesh_aware_plans_blocks():
    """Each leaf of a mesh-aware plan holds rank 0's block (its nb is the
    block's); the checks read the global shapes through ``ShardSpec`` and
    find nothing, where the block read as global would not fit K."""
    from repro_torch.configs.base import get_smoke_config
    from repro_torch.models import model_defs
    from repro_torch.models.params import init_params
    cfg = get_smoke_config("qwen2_7b")
    params = init_params(model_defs(cfg), seed=0, device="cpu", dtype_override="float32")
    plan = engine.build_plan(params, cfg=CFG, mesh=FakeMesh(data=2, model=2),
                             device="cpu")
    cut = [e for e in plan.entries.values() if e.shard.parts > 1]
    assert cut and any(e.leaf["mask"].shape[-3] * CFG.w < e.shape[-2] for e in cut)
    assert not validate_plan(plan).findings
    e = cut[0]
    e.leaf["mask"] = e.leaf["mask"][..., :1, :, :].contiguous()
    assert validate_plan(plan).by_rule("plan/k-dim")


def test_per_tensor_bound_and_budget_equal_the_references():
    """``per_tensor_bound`` within 1e-6 relative of the reference's on every
    leaf of a smoke plan (byte-identical payloads); a schedule's error
    budget below the largest bound gives the reference's findings."""
    from repro import engine as jengine
    from repro.analysis.numerics import per_tensor_bound as j_bound
    from repro.autotune.schedule import StruMSchedule as JSched
    from repro.configs.base import get_smoke_config as j_smoke
    from repro.core.apply import _named_leaves as j_named
    from repro.models import model_defs as j_defs
    import _torch_f64_referee as referee
    from repro_torch.analysis.numerics import leaf_stats_from_plan, per_tensor_bound
    from repro_torch.autotune.schedule import StruMSchedule
    from repro_torch.core.apply import _named_leaves

    jp = referee.jax_params(j_defs(j_smoke("olmo_1b")), 0)
    tp = {}
    for name, leaf in j_named(jp):
        node = tp
        *parents, last = name.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = torch.from_numpy(np.array(leaf))
    jplan = jengine.build_plan(jp, cfg=JCfg(method="mip2q", w=16, p=0.5, L=5))
    tplan = engine.build_plan(tp, cfg=CFG, device="cpu")
    jn, tn = dict(j_named(jp)), dict(_named_leaves(tp))
    bounds = {}
    for name, e in tplan.entries.items():
        got, want = per_tensor_bound(e, tn[name]), j_bound(jplan.entries[name], jn[name])
        assert abs(got - want) <= 1e-6 * max(abs(want), 1e-30), (name, got, want)
        bounds[name] = got
    stats = leaf_stats_from_plan(tplan, tp)
    assert set(stats) == set(tplan.entries) and all(s.err > 0 for s in stats.values())
    budget = sorted(bounds.values())[len(bounds) // 2]
    names = sorted(tplan.entries)
    jsched = JSched(assignments={n: JCfg(method="mip2q", w=16, p=0.5, L=5) for n in names},
                    meta={"budget": {"error_budget": budget}})
    tsched = StruMSchedule(assignments={n: CFG for n in names},
                           meta={"budget": {"error_budget": budget}})
    from repro.analysis import validate_plan as j_validate
    want = j_validate(jengine.build_plan(jp, schedule=jsched), params=jp)
    got = validate_plan(engine.build_plan(tp, schedule=tsched, device="cpu"), params=tp)
    assert got.by_rule("numerics/budget-exceeded")
    assert [(f.rule, f.location) for f in got.findings] == \
        [(f.rule, f.location) for f in want.findings]
    with pytest.raises(ValueError, match="numerics/budget-exceeded"):
        engine.build_plan(tp, schedule=tsched, device="cpu", validate=True)


# -------------------------------------------------------------------- CLI --

def _cli(*argv):
    return subprocess.run([sys.executable, "-m", "repro_torch.analysis", *argv],
                          capture_output=True, text=True, timeout=300, cwd=ROOT,
                          env={"PATH": "/usr/bin:/bin", "PYTHONPATH": str(ROOT / "src"),
                               "OMP_NUM_THREADS": "1", "CUDA_VISIBLE_DEVICES": ""})


def test_cli_exit_codes_json_rules_and_docs():
    from repro_torch.analysis.__main__ import main
    out = _cli("--device", "cpu", "--passes", "registry,pallas", "--json")
    assert out.returncode == 0, out.stderr
    rep = json.loads(out.stdout)
    assert rep["counts"]["error"] == 0 and rep["counts"]["info"] == len(rep["findings"])
    assert all(f["rule"] in RULES for f in rep["findings"])
    rules = _cli("--list-rules")
    assert rules.returncode == 0 and len(rules.stdout.splitlines()) == len(RULES)
    assert main(["--check-docs"]) == 0
    assert main(["--device", "cpu", "--passes", "nope"]) == 2
    with pytest.raises(RuntimeError, match="cuda"):
        main(["--passes", "registry"])          # the default device is the card


def test_cli_docs_tables_are_the_ports_own():
    """--sync-docs rewrites the port's tables only: the reference's
    "### Rules" / "### Registry coverage" tables stay the reference's."""
    from repro_torch.analysis.__main__ import COVERAGE_HEADER, RULES_HEADER
    text = (ROOT / "README.md").read_text()
    assert text.index("### Rules") < text.index(RULES_HEADER)
    assert text.index("### Registry coverage") < text.index(COVERAGE_HEADER)
    assert "`cuda:onehot`" in text.split(COVERAGE_HEADER)[1]
    assert "`cuda:onehot`" not in text.split("### Registry coverage")[1].split(
        "## Install")[0]
