"""The example twins (``repro_torch.examples``) against the reference's
library calls, on the CPU at a tiny width.

One tiny OLMo config (2 layers, d 64, f32 activations) and the reference's
seeded f32 weights, carried across through numpy, serve every twin but
``train_e2e``.  Each twin's ``run`` gets the same numpy inputs as the
reference library calls its reference script makes:

* ``quickstart``: the method table (``fake_quantize_array`` jitted,
  ``rel_l2_error``, ``sqnr_db``) within 1e-4 relative, Eq. 1 and the
  payload bytes (``packed_payload_bytes``) exactly, the largest |y| of the
  matmul within 1e-5, the plan's entries and variants
  (twins: ``xla`` -> ``torch``), dense and served bytes exactly, the
  next-token TV distance within 1e-5;
* ``serve_batch``: six requests through the reference's ``BatchScheduler``
  (mip2q weights and KV pages, chunked prefill): every token, the ticks and
  the cache's bytes exactly;
* ``serve_strum``: the reference's ``serve`` on the dense weights and on each
  fixed config's plan, tokens exactly; the payload bytes against the
  reference's ``tree_compression_report`` exactly; the twin's searched
  schedule JSON loaded by the reference: its plan's entries, variants,
  bytes and served tokens exactly;
* ``train_e2e``: the twin trains the reference's ``SMALL`` config (at f32
  activations) a few steps; its trained weights go through the reference's
  ``fake_quantize`` and ``loss_fn`` (jitted: XLA's reciprocal for
  ``amax / 127`` may move a scale by one ulp): every eval CE within 1e-5
  relative.

The reference's packed plans here hold the port's payloads (byte-identical to
the reference's eager packing, ``tests/test_torch_engine.py``) under the
reference's own selection, as ``tests/test_torch_models.py`` serves them:
packing on the reference side would repeat that check at several seconds a
plan.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import core as jcore
from repro import engine as jengine
from repro.configs.base import get_config as j_get
from repro.configs.base import tiny_variant as j_tiny
from repro.autotune.schedule import StruMSchedule as JSched
from repro.core.apply import packed_payload_bytes as j_payload_bytes
from repro.core.apply import tree_compression_report as j_report
from repro.core.policy import StruMConfig as JCfg
from repro.core.policy import default_policy as j_default_policy
from repro.launch.serve import serve as j_serve
from repro.models import forward_train as j_forward
from repro.models import model_defs as j_model_defs
from repro.models.quantize import serve_tree_bytes as j_tree_bytes
from repro.serving import BatchScheduler as JBatch
from repro.serving import Request as JReq
from repro_torch.configs.base import get_config, tiny_variant
from repro_torch.core.policy import StruMConfig as TCfg
from repro_torch.examples import quickstart, serve_batch, serve_strum, train_e2e
from repro_torch.models.params import params_from_numpy

import _torch_f64_referee as referee

torch.set_num_threads(1)  # xdist runs several workers side by side: one intra-op thread each

FIELDS = ("mask", "hi", "lo", "scale")
MIP2Q = dict(method="mip2q", p=0.5, L=5)
FIXED = {m: dict(method=m, p=0.5, **kw) for m, kw in serve_strum.FIXED}


def _twin(name: str) -> str:
    fam, tail = name.split(":", 1)
    return {"pallas": "cuda", "xla": "torch"}[fam] + ":" + tail


def _set(tree, name, leaf):
    keys = name.split("/")
    for k in keys[:-1]:
        tree = tree[k]
    tree[keys[-1]] = leaf


@pytest.fixture(scope="module")
def model():
    """(reference cfg, port cfg, reference params, port params): tiny OLMo
    at f32 activations."""
    jcfg = dataclasses.replace(j_tiny(j_get("olmo_1b")), dtype="float32")
    tcfg = dataclasses.replace(tiny_variant(get_config("olmo_1b")), dtype="float32")
    jparams = referee.jax_params(j_model_defs(jcfg), 0)
    return jcfg, tcfg, jparams, params_from_numpy(jax.tree.map(np.asarray, jparams),
                                                  device="cpu")


def _reference_served(jparams, tparams, **plan_kw):
    """(the reference's selection-only plan, its served tree): the
    reference's own selection (``pack=False``) around the port's payload."""
    from repro_torch import engine
    tkw = {k: TCfg(**v) if k == "cfg" else v for k, v in plan_kw.items()}
    if "schedule" in tkw:
        from repro_torch.autotune import StruMSchedule
        tkw["schedule"] = StruMSchedule.load(plan_kw["schedule"])
        plan_kw = dict(plan_kw, schedule=JSched.load(plan_kw["schedule"]))
    tplan = engine.build_plan(tparams, device="cpu", **tkw)
    jkw = {k: JCfg(**v) if k == "cfg" else v for k, v in plan_kw.items()}
    jplan = jengine.build_plan(jparams, pack=False, **jkw)
    tree = jax.tree.map(lambda a: a, jparams)
    for name, e in jplan.entries.items():
        leaf = {f: jnp.asarray(tplan[name].leaf[f].numpy()) for f in FIELDS}
        _set(tree, name, dict(leaf, cfg=e.cfg, spec=e.spec))
    return jplan, tree


@pytest.fixture(scope="module")
def served(model):
    """method -> the reference's plan and served tree for that fixed config."""
    _, _, jparams, tparams = model
    return {m: _reference_served(jparams, tparams, cfg=kw) for m, kw in FIXED.items()}


def test_quickstart_matches_the_reference(model, served):
    jcfg, tcfg, jparams, tparams = model
    res = quickstart.run(model_cfg=tcfg, params=tparams, device="cpu")
    rng = np.random.default_rng(0)
    w = jnp.asarray(rng.normal(size=(512, 256)).astype(np.float32))
    x = jnp.asarray(rng.normal(size=(4, 512)).astype(np.float32))
    rows = iter(res["methods"])
    for method, kw in quickstart.METHODS:
        for p in (0.25, 0.5, 0.75):
            cfg = JCfg(method=method, p=p, **kw)
            wq = jax.jit(lambda a: jcore.fake_quantize_array(a, cfg))(w)
            r = next(rows)
            assert (r["method"], r["p"], r["ratio"]) == (method, p, cfg.compression_ratio)
            assert r["rel_l2"] == pytest.approx(float(jcore.rel_l2_error(w, wq)), rel=1e-4)
            assert r["sqnr_db"] == pytest.approx(float(jcore.sqnr_db(w, wq)), rel=1e-4)
    cfg = JCfg(**MIP2Q)
    payload = j_payload_bytes(tuple(w.shape), cfg)
    assert res["weight_bytes"] == payload
    assert res["achieved_ratio"] == payload / float(512 * 256)
    assert res["eq_ratio"] == cfg.compression_ratio == 0.875
    # the twin's kernel against its plain oracle (K1 itself runs on the card)
    y = jnp.asarray(x) @ jcore.fake_quantize_array(w, cfg)
    assert res["kernel_max_ref"] == pytest.approx(float(jnp.max(jnp.abs(y))), rel=1e-5)
    assert res["kernel_max_err"] <= 1e-5 * res["kernel_max_ref"]
    jplan, jserved = served["mip2q"]
    assert res["n_entries"] == len(jplan.entries)
    assert res["variant_distribution"] == {
        _twin(k): v for k, v in jplan.summary()["variant_distribution"].items()}
    assert res["dense_bytes"] == j_tree_bytes(jparams)
    assert res["served_bytes"] == j_tree_bytes(jserved)
    batch = {"tokens": jnp.ones((1, 16), jnp.int32)}
    lg_dense, _ = jax.jit(lambda p: j_forward(p, batch, jcfg))(jparams)
    scfg = dataclasses.replace(jcfg, strum=JCfg(**MIP2Q))
    lg_strum, _ = jax.jit(lambda p: j_forward(p, batch, scfg))(jserved)
    tv = 0.5 * float(jnp.sum(jnp.abs(jax.nn.softmax(lg_dense[0, -1])
                                     - jax.nn.softmax(lg_strum[0, -1]))))
    assert res["tv"] == pytest.approx(tv, abs=1e-5)


def test_serve_batch_matches_the_reference_scheduler(model, served):
    jcfg, tcfg, jparams, tparams = model
    prompts = serve_batch.prompts_for(6, tcfg.vocab_size)
    res = serve_batch.run(tcfg, tparams, prompts, kv_cache="mip2q", device="cpu")
    _, jserved = served["mip2q"]
    sched = JBatch(dataclasses.replace(jcfg, strum=JCfg(**MIP2Q)), jserved, n_slots=3,
                   max_len=64, kv_cache=JCfg(method="mip2q", p=0.5, q=4, L=7),
                   page_size=16, prefill="chunked")
    for i, p in enumerate(prompts):
        sched.submit(JReq(uid=i, prompt=jnp.asarray(p, jnp.int32), max_new_tokens=8,
                          priority=i % 2))
    done = {r.uid: [int(t) for t in r.output]
            for r in sched.run_to_completion(max_steps=500)}
    assert res["outputs"] == done
    assert all(len(o) == 8 for o in done.values()) and res["tokens"] == 48
    st = sched.cache_stats()
    assert res["ticks"] == st["steps"]
    for k in ("resident_page_bytes", "dense_cache_bytes"):
        assert res["cache"][k] == st[k], k
    assert res["cache"]["ratio_vs_int8"] == st["ratio_vs_int8"] == 0.875
    assert res["served_bytes"] == j_tree_bytes(jserved)


def test_serve_strum_matches_the_reference(model, served, tmp_path):
    jcfg, tcfg, jparams, tparams = model
    prompt = np.random.default_rng(1).integers(0, tcfg.vocab_size, (2, 8))
    path = str(tmp_path / "sched.json")
    res = serve_strum.run(tcfg, tparams, prompt, gen=4, schedule_path=path, device="cpu")
    jprompt = jnp.asarray(prompt, jnp.int32)
    toks, _, _ = j_serve(jcfg, jparams, jprompt, 4, {})
    np.testing.assert_array_equal(res["tokens"].numpy(), np.asarray(toks))
    assert res["dense_bytes"] == j_tree_bytes(jparams)
    for m, kw in FIXED.items():
        r, (jplan, jserved) = res["fixed"][m], served[m]
        got, _, _ = j_serve(dataclasses.replace(jcfg, strum=JCfg(**kw)), jserved,
                            jprompt, 4, {})
        np.testing.assert_array_equal(r["tokens"].numpy(), np.asarray(got))
        assert r["agreement"] == pytest.approx(float(np.mean(np.asarray(got) == np.asarray(toks))))
        assert r["bytes"] == j_tree_bytes(jserved)
        rows = [t for t in j_report(jparams, j_default_policy(JCfg(**kw)))["tensors"]
                if t["name"] in jplan.entries]
        assert len(rows) == len(jplan.entries)
        assert r["payload_bytes"] == sum(t["packed_bytes"] for t in rows)
        assert r["int8_bytes"] == sum(t["int8_bytes"] for t in rows)
    a = res["autotune"]
    loaded = JSched.load(path)
    assert a["achieved_ratio"] == loaded.meta["achieved_ratio"] <= 0.875
    jplan, jserved = _reference_served(jparams, tparams, schedule=path)
    assert a["n_packed"] == len(jplan.entries)
    assert a["variants"] == {
        _twin(k): v for k, v in jplan.summary()["variant_distribution"].items()}
    got, _, _ = j_serve(jcfg, jserved, jprompt, 4, {})
    np.testing.assert_array_equal(a["tokens"].numpy(), np.asarray(got))
    assert a["bytes"] == j_tree_bytes(jserved)
    assert a["packed_bytes"] == j_report(jparams, schedule=loaded)["total_packed_bytes"]


def test_train_e2e_weights_hold_the_references_ptq_eval(tmp_path):
    from repro.configs.base import ModelConfig as JModelConfig
    from repro.data.pipeline import DataConfig, global_batch
    from repro.engine import fake_quantize
    from repro.models.transformer import loss_fn
    cfg = dataclasses.replace(train_e2e.SMALL, dtype="float32")
    res = train_e2e.run(cfg, steps=3, batch=2, seq=32, workdir=str(tmp_path),
                        device="cpu", log_fn=lambda _: None)
    assert len(res["losses"]) == 3 and np.all(np.isfinite(res["losses"]))
    jcfg = JModelConfig(**{f.name: getattr(cfg, f.name)
                           for f in dataclasses.fields(cfg) if f.name != "strum"})
    jparams = jax.tree.map(lambda t: jnp.asarray(t.detach().numpy()), res["params"])
    batch = global_batch(DataConfig(vocab_size=cfg.vocab_size, seq_len=32,
                                    global_batch=2, seed=11), 10_000)
    ce = jax.jit(lambda p: loss_fn(p, batch, jcfg)[1]["ce"])
    assert res["eval"]["fp32"] == pytest.approx(float(ce(jparams)), rel=1e-5)
    for method, kw in train_e2e.PTQ:
        scfg = JCfg(method=method, p=0.5, **kw)
        qp = jax.jit(lambda p: fake_quantize(p, cfg=scfg))(jparams)
        assert res["eval"][method] == pytest.approx(float(ce(qp)), rel=1e-5), method
