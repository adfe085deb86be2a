"""Schedule-driven serving: the port's ``build_plan(schedule=)``,
``strum_serve_params``, ``BatchScheduler(schedule=)`` and ``serve
--schedule`` against the JAX reference.

Schedules are heterogeneous: per linear kind its own method, p, q or L,
some tensors left dense, and (the reference's
``tests/test_autotune.py::test_moe_heterogeneous_schedule_partial_packing``)
only some of an MoE layer's ``wi`` / ``wg`` / ``wo`` packed.  The reference
writes each schedule's JSON and the port loads that file.  Payloads are held
byte for byte, variants as twins (``pallas`` -> ``cuda``, ``xla`` ->
``torch``), scheduler logits per position at ``test_torch_serving.py``'s
fp-page tolerance (rtol 1e-4, atol 1e-5: f32 sums in another order).
"""
import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import engine as jengine
from repro.autotune.schedule import StruMSchedule as JSched
from repro.configs.base import get_smoke_config as j_smoke
from repro.core.policy import StruMConfig as JCfg
from repro.models import model_defs as j_model_defs
from repro.models.quantize import strum_serve_params as j_serve_params
from repro.serving import BatchScheduler as JBatch
from repro.serving import Request as JReq
from repro_torch import engine
from repro_torch.autotune import StruMSchedule
from repro_torch.configs.base import get_smoke_config as t_smoke
from repro_torch.core.policy import StruMConfig as TCfg
from repro_torch.launch.steps import build_serving_plan
from repro_torch.models.params import params_from_numpy
from repro_torch.models.quantize import strum_serve_params
from repro_torch.serving import BatchScheduler, Request

import _torch_f64_referee as referee

torch.set_num_threads(1)  # xdist runs several workers side by side: one intra-op thread each

TOL = dict(rtol=1e-4, atol=1e-5)
FIELDS = ("mask", "hi", "lo", "scale")
LENS, NEW = (8, 21, 5), 10

# per linear kind: K1 (mip2q p.5 L5), K2 (dliq p1), K3 (mip2q p0), K1 off
# its byte path (mip2q L7), sparsity and dliq p.25 through K1, dense (None)
OLMO = {"attn/wq/w": dict(method="mip2q", p=0.5, L=5),
        "attn/wk/w": dict(method="dliq", p=1.0, q=4),
        "attn/wv/w": dict(method="mip2q", p=0.0, L=5),
        "attn/wo/w": dict(method="mip2q", p=0.5, L=7),
        "mlp/wi/w": None,
        "mlp/wg/w": dict(method="sparsity", p=0.75),
        "mlp/wo/w": dict(method="dliq", p=0.25, q=4)}
# wi and wo packed (K6, K8), wg left dense; attention mixed
MOONSHOT = {"attn/wq/w": dict(method="dliq", p=1.0, q=4),
            "attn/wk/w": None,
            "attn/wo/w": dict(method="mip2q", p=0.75, L=7),
            "moe/wi": dict(method="mip2q", p=0.5, L=5),
            "moe/wo": dict(method="mip2q", p=0.0, L=5)}
ARCHS = {"olmo_1b": OLMO, "moonshot_v1_16b_a3b": MOONSHOT}


def _twin(name: str) -> str:
    fam, tail = name.split(":", 1)
    return {"pallas": "cuda", "xla": "torch"}[fam] + ":" + tail


@pytest.fixture(scope="module", params=list(ARCHS))
def arch(request, tmp_path_factory):
    """(reference cfg, port cfg, reference params, port params, the
    reference's schedule and the path of its JSON)."""
    name = request.param
    jcfg, tcfg = j_smoke(name), t_smoke(name)
    jparams = referee.jax_params(j_model_defs(jcfg), 0)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    jsched = JSched(assignments={f"blocks/pos0/{k}": c and JCfg(**c)
                                 for k, c in ARCHS[name].items()},
                    meta={"source": "test_torch_schedule_serving"})
    path = jsched.save(str(tmp_path_factory.mktemp(name) / "sched.json"))
    return jcfg, tcfg, jparams, tparams, jsched, path


def _leaf_at(tree, name):
    for k in name.split("/"):
        tree = tree[k]
    return tree


def test_schedule_plan_payloads_byte_identical(arch):
    jcfg, tcfg, jparams, tparams, jsched, path = arch
    tsched = StruMSchedule.load(path)
    for jb, tb in ((None, None), ("pallas", "cuda")):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            jplan = jengine.build_plan(jparams, schedule=jsched, backend=jb)
            tplan = build_serving_plan(tparams, schedule=tsched, backend=tb,
                                       device="cpu")
        packed = {n for n, c in jsched.assignments.items() if c is not None}
        assert set(tplan.entries) == set(jplan.entries) == packed
        assert tplan.schedule is tsched and tplan.scope == "model"
        for name, je in jplan.entries.items():
            te = tplan[name]
            assert te.variant == _twin(je.variant), (name, tb)
            assert te.shape == je.shape and te.cfg == tsched.assignments[name]
            for f in FIELDS:
                a, b = np.asarray(je.leaf[f]), te.leaf[f].numpy()
                assert a.dtype == b.dtype and a.shape == b.shape, (name, f)
                assert a.tobytes() == b.tobytes(), (name, f)
            assert _leaf_at(tplan.params, name)["spec"] == te.spec
        # unassigned and None-assigned tensors stay dense, as upstream
        for name, cfg in tsched.assignments.items():
            if cfg is None:
                assert isinstance(_leaf_at(tplan.params, name), torch.Tensor)
        js, ts = jplan.summary(), tplan.summary()
        assert ts["variant_distribution"] == {
            _twin(k): v for k, v in js["variant_distribution"].items()}
        assert ts["packed_payload_bytes"] == js["packed_payload_bytes"]
    if jcfg.n_experts:
        # the cuda family runs the packed stacks on K6 and K8, wg dense
        assert tplan["blocks/pos0/moe/wi"].variant == "cuda:grouped"
        assert tplan["blocks/pos0/moe/wo"].variant == "cuda:grouped_dense"
        assert isinstance(tplan.params["blocks"]["pos0"]["moe"]["wg"], torch.Tensor)
    else:
        assert {tplan[f"blocks/pos0/{k}"].variant for k in ("attn/wq/w", "attn/wo/w",
                "mlp/wg/w", "mlp/wo/w")} == {"cuda:onehot"}
        assert tplan["blocks/pos0/attn/wk/w"].variant == "cuda:maskfree"
        assert tplan["blocks/pos0/attn/wv/w"].variant == "cuda:dense"


def test_schedule_beats_uniform_cfg_for_expert_stacks(arch):
    """Precedence: with a schedule, expert stacks follow it, not ``cfg``."""
    jcfg, _, jparams, tparams, jsched, path = arch
    tsched = StruMSchedule.load(path)
    cfg = dict(method="sparsity", p=0.25)
    jplan = jengine.build_plan(jparams, schedule=jsched, cfg=JCfg(**cfg))
    tplan = engine.build_plan(tparams, schedule=tsched, cfg=TCfg(**cfg), device="cpu")
    assert {n: e.cfg for n, e in tplan.entries.items()} == \
        {n: tsched.assignments[n] for n in jplan.entries}
    # without a schedule the legacy rule packs every stack with cfg
    if jcfg.n_experts:
        uniform = engine.build_plan(tparams, cfg=TCfg(**cfg), device="cpu")
        assert all(uniform[f"blocks/pos0/moe/{k}"].cfg == TCfg(**cfg)
                   for k in ("wi", "wg", "wo"))


def test_strum_serve_params_matches_reference(arch):
    jcfg, tcfg, jparams, tparams, jsched, path = arch
    with pytest.deprecated_call():
        jserved = j_serve_params(jparams, jcfg, schedule=jsched)
    with pytest.deprecated_call():
        tserved = strum_serve_params(tparams, tcfg, schedule=StruMSchedule.load(path),
                                     device="cpu")
    for name in jsched.assignments:
        j, t = _leaf_at(jserved, name), _leaf_at(tserved, name)
        if isinstance(j, dict):
            for f in FIELDS:
                assert np.asarray(j[f]).tobytes() == t[f].numpy().tobytes(), (name, f)
            assert t["cfg"] == StruMSchedule.load(path).assignments[name]
        else:
            np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    with pytest.raises(ValueError, match="cfg.strum or pass a schedule"):
        with pytest.deprecated_call():
            strum_serve_params(tparams, tcfg, device="cpu")


def _record(sched, vocab):
    """Every request's logits in the order its tokens come out (the prefill
    lane's first token, then each decode tick), on either scheduler."""
    rec: dict = {}
    decode, chunk = sched._decode, sched._chunk_prefill

    def add(uid, row):
        rec.setdefault(uid, []).append(np.asarray(row, dtype=np.float32)[:vocab])

    def dec(params, token, pools, hot, cache_len, table, active):
        lg, hot = decode(params, token, pools, hot, cache_len, table, active)
        for s in np.nonzero(np.asarray(active))[0]:
            add(sched.slots[s].req.uid, lg[s, -1])
        return lg, hot

    def chk(params, toks, pools, hot, table, slot, start, valid):
        out = chunk(params, toks, pools, hot, table, slot, start, valid)
        sl = sched.slots[int(slot)]
        if int(start) + int(valid) >= int(sl.req.prompt.shape[0]):
            add(sl.req.uid, out[0][0, int(valid) - 1])
        return out
    sched._decode, sched._chunk_prefill = dec, chk
    return rec


def test_scheduler_from_schedule_path_matches_reference(arch):
    """Both schedulers load the same JSON file, teacher-forced on one token
    sequence; every position's logits agree."""
    jcfg, tcfg, jparams, tparams, jsched, path = arch
    # f32 activations, as test_torch_serving.py runs its schedulers
    jcfg, tcfg = (dataclasses.replace(c, dtype="float32") for c in (jcfg, tcfg))
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, 256, size=(n,)).astype(np.int32) for n in LENS]
    forced = [rng.integers(0, 256, size=(NEW,)).tolist() for _ in LENS]
    recs = []
    for cls, req, cfg, params, as_prompt, kw in (
            (JBatch, JReq, jcfg, jparams, jnp.asarray, {}),
            (BatchScheduler, Request, tcfg, tparams, torch.from_numpy,
             dict(device="cpu"))):
        sched = cls(cfg, params, n_slots=2, max_len=48, schedule=path, **kw)
        rec = _record(sched, cfg.vocab_size)
        for i, (p, f) in enumerate(zip(prompts, forced)):
            sched.submit(req(uid=i, prompt=as_prompt(p), max_new_tokens=NEW,
                             force_tokens=f))
        done = {r.uid: r for r in sched.run_to_completion(max_steps=500)}
        assert sorted(done) == [0, 1, 2]
        recs.append((sched, rec))
    (js, jrec), (ts, trec) = recs
    assert isinstance(ts.schedule, StruMSchedule) and ts.plan.schedule is ts.schedule
    assert ts.plan.variants() == {n: _twin(v) for n, v in js.plan.variants().items()}
    assert ts._steps == js._steps
    for uid in jrec:
        assert len(jrec[uid]) == len(trec[uid]) == NEW
        np.testing.assert_allclose(np.stack(trec[uid]), np.stack(jrec[uid]), **TOL,
                                   err_msg=f"request {uid}")


def test_scheduler_refusals_and_backend(arch):
    _, tcfg, _, tparams, _, path = arch
    sched = StruMSchedule.load(path)
    plan = build_serving_plan(tparams, schedule=sched, device="cpu")
    with pytest.raises(ValueError, match="not both"):
        BatchScheduler(tcfg, tparams, plan=plan, schedule=sched, device="cpu")
    with pytest.raises(ValueError, match="backend= only applies"):
        BatchScheduler(tcfg, None, plan=plan, backend="torch", device="cpu")
    # a prebuilt plan carries its schedule; backend= pins the built plan's family
    assert BatchScheduler(tcfg, None, plan=plan, device="cpu").schedule is sched
    pinned = BatchScheduler(tcfg, tparams, schedule=sched, backend="cuda", device="cpu")
    assert pinned.schedule is sched and pinned.plan.backend == "cuda"
    assert set(pinned.plan.variants().values()) <= {
        "cuda:onehot", "cuda:maskfree", "cuda:dense", "cuda:grouped",
        "cuda:grouped_dense"}


def test_speculative_lane_accepts_a_schedule_plan(arch):
    """Greedy speculative decoding on a schedule-built plan gives the plain
    lane's tokens; the drafted leaves are build_draft_plan's mode map: the
    2-D entries with both high and low values (p = 1 and p = 0 payloads and
    expert stacks have no draft lowering and stay exact)."""
    _, tcfg, _, tparams, _, path = arch
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, 256, size=(n,)).astype(np.int32) for n in (6, 13)]
    outs = []
    for k in (0, 2):
        sched = BatchScheduler(tcfg, tparams, n_slots=2, max_len=48, schedule=path,
                               speculative=k, device="cpu")
        for i, p in enumerate(prompts):
            sched.submit(Request(uid=i, prompt=torch.from_numpy(p), max_new_tokens=12))
        outs.append({r.uid: r.output for r in sched.run_to_completion(max_steps=500)})
    assert outs[0] == outs[1]
    assert sched.lane_runs["draft"] > 0 and sched.lane_runs["decode"] == 0
    modes = sched.draft_plan.meta["draft"]
    want = engine.build_draft_plan(sched.plan, engine.DraftPolicy()).meta["draft"]
    assert modes == want
    drafted = {n for n, e in sched.plan.entries.items()
               if "/moe/" not in n and 0 < e.cfg.n_low < e.cfg.w}
    assert {n for n, m in modes.items() if m} == drafted and drafted
    assert set(modes) == set(sched.plan.entries)


def test_serve_entry_point_takes_a_schedule(arch, capsys):
    jcfg, _, _, _, jsched, path = arch
    from repro_torch.launch import serve as S
    argv = ["--arch", jcfg.name.removesuffix("_smoke"), "--smoke", "--device", "cpu",
            "--schedule", path, "--strum", "sparsity", "--gen", "3", "--prompt-len", "8"]
    assert S.main(argv) == 0
    out = capsys.readouterr().out
    n_packed = sum(c is not None for c in jsched.assignments.values())
    assert f"plan: {n_packed} entries, variants {{'torch:dequant': {n_packed}}}" in out
    assert f"schedule {path}" in out and "kept dense" in out and "of their int8" in out
    assert S.main(argv + ["--paged", "--kv-cache", "mip2q", "--prompt-len", "20"]) == 0
    out = capsys.readouterr().out
    assert "4 requests" in out and "x0.8750 vs int8 pages" in out


def test_new_entry_points_raise_without_a_card(arch, monkeypatch):
    """The tree-scope, fake-quant and schedule entry points default to the
    card, as every entry point of the port does: without one they raise."""
    from repro_torch.core import apply as tapply
    _, tcfg, _, tparams, _, path = arch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    sched = StruMSchedule.load(path)
    calls = [lambda: engine.build_plan(tparams, schedule=sched),
             lambda: engine.build_plan(tparams, scope="tree"),
             lambda: engine.fake_quantize(tparams, schedule=sched),
             lambda: BatchScheduler(tcfg, tparams, schedule=path),
             lambda: build_serving_plan(tparams, schedule=sched)]
    for call in calls:
        with pytest.raises(RuntimeError, match="cuda"):
            call()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        for call in (lambda: tapply.pack_tree(tparams),
                     lambda: tapply.fake_quantize_tree(tparams),
                     lambda: strum_serve_params(tparams, tcfg, schedule=sched)):
            with pytest.raises(RuntimeError, match="cuda"):
                call()
