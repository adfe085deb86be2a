"""``repro_torch.telemetry`` against ``repro.telemetry``: the cases of the
reference's ``tests/test_telemetry.py`` on the port (disabled path, stacked
recorders, dispatch counters against the plan, scheduler lifecycle, the
validator, latency math, trace export and CLI), plus the port's traces
checked by the reference's own ``repro.telemetry.check`` and the port's
scheduler and page counters held equal to the reference's on one run.

The one documented difference: the reference counts a dispatch once per
leaf per ``jax.jit`` trace, the eager port once per call.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import telemetry as jtelemetry
from repro.configs.base import get_smoke_config as j_smoke
from repro.core.policy import StruMConfig as JCfg
from repro.models import model_defs as j_model_defs
from repro.serving import BatchScheduler as JSched
from repro.serving import Request as JReq
from repro.telemetry import check as jcheck
from repro_torch import engine, telemetry
from repro_torch.configs.base import get_smoke_config as t_smoke
from repro_torch.core.policy import DEFAULT_EXCLUDE, LayerPolicy
from repro_torch.core.policy import StruMConfig as TCfg
from repro_torch.models import transformer as tfm
from repro_torch.models.params import params_from_numpy
from repro_torch.serving import BatchScheduler, Request
from repro_torch.telemetry import check
from repro_torch.telemetry.recorder import _STACK, NULL_SPAN

import _torch_f64_referee as referee

torch.set_num_threads(1)  # xdist runs several workers side by side: one intra-op thread each

RNG = np.random.default_rng(0)


@pytest.fixture(scope="module")
def setup():
    jcfg = dataclasses.replace(j_smoke("qwen2_7b"), dtype="float32")
    tcfg = dataclasses.replace(t_smoke("qwen2_7b"), dtype="float32")
    jparams = referee.jax_params(j_model_defs(jcfg), 0)
    return jcfg, tcfg, jparams, params_from_numpy(jax.tree.map(np.asarray, jparams),
                                                  device="cpu")


@pytest.fixture(autouse=True)
def _stack_balanced():
    """Every test leaves the recorder stack exactly as it found it."""
    before = list(_STACK)
    yield
    assert _STACK == before


def _hetero_policy():
    return LayerPolicy(default=None, exclude=DEFAULT_EXCLUDE, overrides=(
        (r"/attn/", TCfg(method="mip2q", p=0.5, L=5, w=16)),
        (r"/mlp/", TCfg(method="dliq", p=0.5, q=4, w=8))))


# ------------------------------------------------------------ disabled path

def test_disabled_recorder_is_noop():
    assert not telemetry.enabled()
    assert telemetry.current() is None
    telemetry.inc("x", 3)
    telemetry.gauge("g", 1.0)
    telemetry.observe("h", 2.0)
    telemetry.event("e", cat="test")
    telemetry.request_event(0, "submitted")
    s = telemetry.span("a")
    assert s is telemetry.span("b", cat="other") is NULL_SPAN
    with s:
        pass
    with telemetry.recording() as rec:
        assert rec.empty
    assert rec.empty
    assert not telemetry.enabled()


def test_disabled_dispatch_leaves_no_state():
    """Instrumented engine, cache and scheduler code run with no recorder
    records nothing, and a recorder of the reference sees nothing of it."""
    w = torch.from_numpy(RNG.normal(size=(16, 8)).astype(np.float32))
    plan = engine.build_plan({"blocks": {"w": w}}, cfg=TCfg(method="dliq", q=4),
                             device="cpu")
    (entry,) = plan.entries.values()
    with jtelemetry.recording() as jrec:
        engine.dispatch(entry.leaf, torch.from_numpy(RNG.normal(size=(2, 16)).astype(
            np.float32)))
    assert jrec.empty
    with telemetry.recording() as rec:
        assert rec.empty


def test_recorder_stack_broadcasts():
    outer = telemetry.configure()
    try:
        with telemetry.recording() as inner:
            telemetry.inc("k")
            with telemetry.span("s:one"):
                pass
        assert inner.counter("k") == 1
        assert outer.counter("k") == 1
        assert len(inner.spans("s:")) == len(outer.spans("s:")) == 1
    finally:
        telemetry.shutdown(outer)
    assert not telemetry.enabled()


# ------------------------------------------- dispatch counters vs the plan

def _group0(leaf):
    return {k: v[0] if isinstance(v, torch.Tensor) else v for k, v in leaf.items()}


def test_dispatch_counters_match_plan_distribution(setup):
    """One dispatch per entry of a plan whose draft twin mixes families
    yields exactly its variant_distribution, and the packed-bytes counter is
    the payload each variant streams; one eager forward counts each entry
    once per layer group."""
    _, tcfg, _, tparams = setup
    target = engine.build_plan(tparams, policy=_hetero_policy(), device="cpu")
    plan = engine.build_draft_plan(target, engine.DraftPolicy(
        mode="histream", overrides=(("/mlp/", "full"),)))
    summ = plan.summary()
    dist = summ["variant_distribution"]
    assert dist == {"draft:torch_histream": 4, "torch:dequant": 3}
    draft_bytes = engine.draft_plan_bytes(plan)["draft_bytes"]
    with telemetry.recording() as rec:
        for name, entry in plan.entries.items():
            leaf = _group0(entry.leaf)
            x = torch.from_numpy(RNG.normal(size=(1, entry.shape[-2])).astype(np.float32))
            engine.dispatch(leaf, x)
    assert rec.counters("dispatch/variant/") == dist
    groups = tfm.n_groups(tcfg)
    assert rec.counter("dispatch/packed_bytes") * groups == draft_bytes
    mlp = sum(e.payload_bytes() for n, e in plan.entries.items() if "/mlp/" in n)
    assert rec.counter("spec/draft_packed_bytes") * groups == draft_bytes - mlp

    with telemetry.recording() as rec:
        tfm.forward_train(plan.params, {"tokens": torch.zeros((1, 4), dtype=torch.long)},
                          tcfg)
    assert rec.counters("dispatch/variant/") == {k: v * groups for k, v in dist.items()}
    assert rec.counter("dispatch/packed_bytes") == draft_bytes


# --------------------------------------------- scheduler lifecycle streams

def test_scheduler_lifecycle_well_ordered(setup):
    _, tcfg, _, tparams = setup
    rng = np.random.default_rng(3)
    with telemetry.recording() as rec:
        sched = BatchScheduler(tcfg, tparams, n_slots=2, max_len=48, device="cpu")
        for i in range(3):
            pr = torch.from_numpy(rng.integers(0, tcfg.vocab_size, size=(6 + i,)))
            sched.submit(Request(uid=i, prompt=pr, max_new_tokens=4))
        done = sched.run_to_completion(max_steps=200)
        st = sched.cache_stats()
    assert len(done) == 3 and st["codec"] == "cache:fp_passthrough"

    log = rec.request_log()
    assert set(log) == {0, 1, 2}
    for uid, events in log.items():
        telemetry.check_well_ordered(events)
        stages = [s for s, _, _ in events]
        for want in ("submitted", "admitted", "prefill", "first_token", "retired"):
            assert want in stages, (uid, stages)

    lat = rec.latency_summary()
    assert lat["n_requests"] == lat["n_retired"] == 3
    assert lat["good_tokens"] == 12
    assert lat["ttft_p50_us"] > 0 and lat["goodput_tok_s"] > 0

    c = rec.counters()
    assert c["sched/submitted"] == c["sched/admitted"] == 3
    assert c["sched/retired"] == 3
    assert c["sched/ticks"] == sched._steps
    assert c["pages/alloc"] > 0 and c["pages/freed"] > 0
    assert rec.spans("sched:step") and rec.spans("sched:prefill")
    assert rec.spans("sched:decode")
    assert rec.gauge_series("sched/queue_depth")
    assert rec.gauge_series("pages/in_use")
    g = rec.gauges()
    assert g["cache/resident_packed_bytes"] == 0
    assert g["cache/resident_fp_bytes"] > 0
    assert g["cache/ratio_vs_int8"] == st["ratio_vs_int8"]


def _serve_traced(side, setup, speculative=0, **kw):
    jcfg, tcfg, jparams, tparams = setup
    if side == "ref":
        from repro import engine as jengine
        plan = jengine.build_plan(jparams, cfg=JCfg(method="dliq", p=0.5, q=4))
        sched = JSched(jcfg, plan.params, n_slots=2, max_len=48, plan=plan,
                       kv_cache=JCfg(method="dliq", p=0.5, q=4),
                       cache_backend="interpret", speculative=speculative, **kw)
        req, as_prompt, rec_ctx = JReq, jnp.asarray, jtelemetry.recording
    else:
        plan = engine.build_plan(tparams, cfg=TCfg(method="dliq", p=0.5, q=4),
                                 device="cpu")
        sched = BatchScheduler(tcfg, None, n_slots=2, max_len=48, plan=plan,
                               kv_cache=TCfg(method="dliq", p=0.5, q=4),
                               cache_backend="cuda", speculative=speculative,
                               device="cpu", **kw)
        req, as_prompt, rec_ctx = Request, torch.from_numpy, telemetry.recording
    rng = np.random.default_rng(4)
    with rec_ctx() as rec:
        for i, n in enumerate((19, 7, 9)):
            sched.submit(req(uid=i, prompt=as_prompt(rng.integers(
                0, 256, size=(n,)).astype(np.int32)), max_new_tokens=12))
        done = sched.run_to_completion(max_steps=300)
        sched.cache_stats()
    return rec, {r.uid: r.output for r in done}


@pytest.mark.parametrize("speculative", [0, 2])
def test_scheduler_counters_equal_the_reference(setup, speculative):
    """The same requests on both sides (packed dliq pages): the same
    tokens, and equal ``sched/*``, ``pages/*`` and ``spec/*`` counters,
    request logs of the same stages, gauges and span names; ``attn/*`` and
    ``cache/*`` counters by name (the reference counts those per trace)."""
    kw = dict(draft="histream") if speculative else {}
    rec, out = _serve_traced("port", setup, speculative, **kw)
    jrec, jout = _serve_traced("ref", setup, speculative, **kw)
    assert out == jout
    pick = ("sched/", "pages/", "spec/drafted", "spec/accepted", "spec/rounds")
    got = {k: v for k, v in rec.counters().items() if k.startswith(pick)}
    want = {k: v for k, v in jrec.counters().items() if k.startswith(pick)}
    assert got == want and got["sched/retired"] == 3
    assert (rec.counter("spec/draft_packed_bytes") > 0) == bool(speculative)
    names = {k.replace("cuda", "pallas") for k in rec.counters()
             if k.startswith(("attn/", "cache/"))}
    jnames = {k for k in jrec.counters() if k.startswith(("attn/", "cache/"))}
    assert names == jnames, (names, jnames)
    assert set(rec.gauges()) == set(jrec.gauges())
    assert rec.gauges()["pages/in_use"] == jrec.gauges()["pages/in_use"]
    assert {s["name"] for s in rec.spans() if s["name"].startswith(("sched:", "spec:"))} \
        == {s["name"] for s in jrec.spans() if s["name"].startswith(("sched:", "spec:"))}
    for uid, events in rec.request_log().items():
        assert [e[0] for e in events] == [e[0] for e in jrec.request_log()[uid]]


def test_check_well_ordered_rejects_bad_streams():
    with pytest.raises(ValueError, match="before 'first_token'"):
        telemetry.check_well_ordered([("token", 0.0, {})])
    with pytest.raises(ValueError, match="out of order"):
        telemetry.check_well_ordered([("admitted", 0.0, {}), ("submitted", 1.0, {})])
    with pytest.raises(ValueError, match="regressed"):
        telemetry.check_well_ordered([("submitted", 5.0, {}), ("admitted", 1.0, {})])
    with pytest.raises(ValueError, match="unknown"):
        telemetry.check_well_ordered([("warp", 0.0, {})])
    telemetry.check_well_ordered([("submitted", 0.0, {}), ("retired", 1.0, {})])


# ------------------------------------------------------------ latency math

def test_latency_summary_synthetic_log():
    log = {
        1: [("submitted", 0.0, {}), ("admitted", 10.0, {}), ("prefill", 20.0, {}),
            ("first_token", 100.0, {}), ("decode", 100.0, {}), ("token", 150.0, {}),
            ("token", 250.0, {}), ("retired", 250.0, {})],
        2: [("submitted", 0.0, {}), ("first_token", 200.0, {}),
            ("retired", 200.0, {})],
    }
    m = telemetry.request_metrics(log)
    assert m[1]["ttft_us"] == 100 and m[1]["queue_us"] == 10
    assert m[1]["e2e_us"] == 250 and m[1]["n_tokens"] == 3
    assert m[1]["token_intervals_us"] == [50, 100]
    assert m[2]["n_tokens"] == 1 and m[2]["token_intervals_us"] == []
    s = telemetry.latency_summary(log)
    assert s["n_requests"] == s["n_retired"] == 2
    assert s["ttft_p50_us"] == pytest.approx(150.0)
    assert s["ttft_p99_us"] == pytest.approx(199.0)
    assert s["tok_p50_us"] == pytest.approx(75.0)
    assert s["good_tokens"] == 4 and s["wall_us"] == 250
    assert s["goodput_tok_s"] == pytest.approx(4 / 250e-6)
    assert s == jtelemetry.latency_summary(log)
    assert telemetry.percentile([], 50) is None
    assert telemetry.percentile([7.0], 99) == 7.0


# ------------------------------------------------- trace export + validator

def test_trace_export_validator_and_cli(tmp_path):
    p = tmp_path / "trace.json"
    with telemetry.recording(trace_path=str(p)):
        with telemetry.span("sched:step", cat="sched", tick=0):
            pass
        with telemetry.span("cache:cuda_decode", cat="cache"):
            pass
        telemetry.inc("dispatch/packed_bytes", 128)
        telemetry.gauge("pages/in_use", 3)
        telemetry.event("page_alloc", cat="pages", n=2)
        telemetry.request_event(0, "submitted")
        telemetry.request_event(0, "first_token")
        telemetry.request_event(0, "retired")
    data = telemetry.validate_chrome_trace(str(p))
    assert telemetry.require_spans(data, ["sched:", "cache:"]) == {"sched:": 1,
                                                                  "cache:": 1}
    with pytest.raises(ValueError, match="missing required spans"):
        telemetry.require_spans(data, ["nonexistent:"])
    tele = data["strumTelemetry"]
    assert tele["counters"]["dispatch/packed_bytes"] == 128
    assert tele["gauges"]["pages/in_use"] == 3
    assert tele["latency_summary"]["n_requests"] == 1
    assert tele["dropped_events"] == 0
    for main in (check.main, jcheck.main):
        assert main([str(p), "--require", "sched:", "--require", "cache:"]) == 0
        assert main([str(p), "--require", "nope:"]) == 1
        assert main([str(tmp_path / "absent.json")]) == 1


def test_validate_chrome_trace_rejects_malformed():
    with pytest.raises(ValueError, match="traceEvents"):
        telemetry.validate_chrome_trace({"foo": 1})
    with pytest.raises(ValueError, match="missing phase"):
        telemetry.validate_chrome_trace({"traceEvents": [{"name": "x"}]})
    with pytest.raises(ValueError, match="'dur'"):
        telemetry.validate_chrome_trace({"traceEvents": [{"ph": "X", "name": "x",
                                                          "ts": 0}]})


def test_serve_trace_passes_both_checkers(tmp_path, capsys):
    """``serve --paged --speculative --trace``: the port's trace file holds
    the scheduler's, the speculative lane's and the attention spans, and
    both the port's and the reference's checker accept it."""
    from repro_torch.launch import serve
    path = tmp_path / "t.json"
    try:
        assert serve.main(["--arch", "olmo_1b", "--smoke", "--device", "cpu", "--paged",
                           "--kv-cache", "dliq", "--gen", "4", "--prompt-len", "20",
                           "--speculative", "3", "--trace", str(path)]) == 0
    finally:
        telemetry.shutdown()
    out = capsys.readouterr().out
    assert "telemetry: 5/5 retired" in out and "draft:torch_histream" in out
    req = ["--require", "sched:", "--require", "spec:draft", "--require", "spec:verify",
           "--require", "attn:"]
    assert check.main([str(path)] + req) == 0
    assert jcheck.main([str(path)] + req) == 0
    data = json.loads(path.read_text())["strumTelemetry"]["counters"]
    assert data["spec/drafted"] > 0 and data["spec/rounds"] > 0
    assert data["spec/draft_packed_bytes"] > 0
