"""The port's MoE family against the JAX reference, on the CPU.

Smoke configs of both MoE architectures (``moonshot_v1_16b_a3b``: 4
experts top-2 after ``tiny_variant``; ``qwen3_moe_235b_a22b``: the same
with GQA), f32 activations, reference params carried across through numpy;
packed plans carry the port's payloads into the reference (payload identity
is held in test_torch_grouped.py).

Tolerances, each stated with its test:

* routing: the dispatch buffer (which token sits in which expert slot, and
  which assignments drop) is compared exactly, with and without drops;
* ``moe_apply`` outputs rtol 1e-4, atol 1e-5 and aux rtol 1e-5 (f32 sums in
  another order);
* ``forward_train`` / prefill / decode logits rtol 1e-4, atol 1e-5 (as
  test_torch_models.py), aux rtol 1e-5;
* greedy tokens teacher-forced against ``repro.launch.serve.serve``: equal
  except at a near tie (logits within 1e-4), as test_torch_models.py;
* the paged ``BatchScheduler`` per position: fp pages rtol 1e-4 / atol 1e-5,
  mip2q pages rtol 1e-3 / atol 2e-3 (test_torch_serving.py's, which says
  why packed pages cannot be held tighter); the reference's half runs in a
  pinned process of its own (``_torch_ranks.pinned_reference``) on weights
  drawn from one numpy generator (seed 0, ``_torch_f64_referee.numpy_params``),
  so neither what ran earlier in the test's process nor its hash salt can
  move it.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import engine as jengine
from repro.configs.base import get_smoke_config as j_smoke
from repro.core.policy import StruMConfig as JCfg
from repro.launch.serve import pad_caches as j_pad_caches
from repro.launch.serve import serve as j_serve
from repro.models import decode_step as j_decode_step
from repro.models import forward_train as j_forward
from repro.models import model_defs as j_model_defs
from repro.models import moe as jmoe
from repro.models import prefill as j_prefill
from repro.serving import BatchScheduler as JSched
from repro.serving import Request as JReq
from repro_torch import engine
from repro_torch.configs.base import get_smoke_config as t_smoke
from repro_torch.core.policy import StruMConfig as TCfg
from repro_torch.launch.serve import pad_caches, serve
from repro_torch.models import decode_step, forward_train, moe, prefill
from repro_torch.models.params import params_from_numpy
from repro_torch.serving import BatchScheduler, Request

import _torch_f64_referee as referee
import _torch_ranks as ranks

torch.set_num_threads(1)  # xdist runs several workers side by side: one intra-op thread each

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL, ATOL = 1e-4, 1e-5
AUX_RTOL = 1e-5
FIELDS = ("mask", "hi", "lo", "scale")
ARCHS = ["moonshot_v1_16b_a3b", "qwen3_moe_235b_a22b"]
PLANS = {"dense": None, "mip2q_p0.5": dict(method="mip2q", p=0.5, L=5),
         "dliq_p1.0": dict(method="dliq", p=1.0, q=4),
         "dliq_p0": dict(method="dliq", p=0.0, q=4)}
B, PROMPT, STEPS, SEQ = 2, 8, 3, 40


def _cfgs(arch):
    return (dataclasses.replace(j_smoke(arch), dtype="float32"),
            dataclasses.replace(t_smoke(arch), dtype="float32"))


@pytest.fixture(scope="module", params=ARCHS)
def arch_params(request):
    jcfg, tcfg = _cfgs(request.param)
    jparams = referee.jax_params(j_model_defs(jcfg), 0)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    return request.param, jparams, tparams


# ---------------------------------------------------------------- routing --

class _Cfg:
    n_experts = 4
    top_k = 2
    capacity_factor = 8.0
    gated_mlp = True


def _local_inputs(seed=0, t=32, d=16, e=4, f=32):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(t, d)).astype(np.float32),
            rng.normal(size=(d, e)).astype(np.float32),
            (rng.normal(size=(e, d, f)) / np.sqrt(d)).astype(np.float32),
            (rng.normal(size=(e, d, f)) / np.sqrt(d)).astype(np.float32),
            (rng.normal(size=(e, f, d)) / np.sqrt(f)).astype(np.float32))


def _recording(monkeypatch, module, contract):
    """Wrap ``module._expert_contract`` to keep the dispatch buffer its first
    call (wi) sees."""
    bufs = []

    def rec(wstack, xbuf, *a, **kw):
        bufs.append(np.asarray(xbuf))
        return contract(wstack, xbuf, *a, **kw)
    monkeypatch.setattr(module, "_expert_contract", rec)
    return bufs


@pytest.mark.parametrize("case", ["ample", "drops", "local_shard"])
def test_routing_capacity_and_drops_equal_reference(monkeypatch, case):
    """Which token sits in which expert slot, and which assignments drop,
    equal the reference's exactly: the dispatch buffers (distinct random
    rows of x in their slots, zeros elsewhere) are compared bit for bit."""
    x, router, wi, wg, wo = _local_inputs()
    cfg = type("Cfg", (_Cfg,), {"capacity_factor": 0.5 if case == "drops" else 8.0})
    e_offset, sl = (2, slice(2, 4)) if case == "local_shard" else (0, slice(None))
    cap = jmoe._capacity(x.shape[0], cfg)
    assert cap == moe._capacity(x.shape[0], cfg)
    jbufs = _recording(monkeypatch, jmoe, jmoe._expert_contract)
    tbufs = _recording(monkeypatch, moe, moe._expert_contract)
    jy, (jdf, jpf) = jmoe._moe_local(jnp.asarray(x), jnp.asarray(router),
                                     jnp.asarray(wi[sl]), jnp.asarray(wg[sl]),
                                     jnp.asarray(wo[sl]), cfg, e_offset, cap)
    ty, (tdf, tpf) = moe._moe_local(*(torch.from_numpy(a) for a in
                                      (x, router, wi[sl], wg[sl], wo[sl])),
                                    cfg, e_offset, cap)
    assert np.array_equal(tbufs[0], jbufs[0])
    np.testing.assert_array_equal(tdf.numpy(), np.asarray(jdf))
    np.testing.assert_allclose(tpf.numpy(), np.asarray(jpf), rtol=1e-6)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-4, atol=1e-5)
    r = moe._route(torch.from_numpy(x), torch.from_numpy(router), cfg, e_offset,
                   wi[sl].shape[0], cap)
    kept = int(r["keep"].sum())
    assert kept == int((np.abs(jbufs[0]).sum(-1) > 0).sum())
    if case == "drops":
        assert kept < x.shape[0] * cfg.top_k
        assert (np.linalg.norm(ty.numpy(), axis=-1) == 0).any()   # dropped tokens
    elif case == "ample":
        assert kept == x.shape[0] * cfg.top_k


def test_capacity_formula_equals_reference():
    for arch in ARCHS:
        for over in ({}, {"capacity_factor": 1.25}, {"top_k": 6, "n_experts": 64}):
            cfg = dataclasses.replace(t_smoke(arch), **over)
            for tokens in (1, 4, 6, 16, 24, 128, 1000):
                assert moe._capacity(tokens, cfg) == jmoe._capacity(tokens, cfg)


@pytest.mark.parametrize("arch", ["olmo_1b", "qwen2_7b"] + ARCHS)
def test_config_matches_reference(arch):
    """Full and smoke configs equal the reference's field by field, with the
    same MoE layer pattern and parameter counts (the serve report's)."""
    from repro.configs.base import get_config as j_config
    from repro_torch.configs.base import get_config as t_config
    for jcfg, tcfg in ((j_config(arch), t_config(arch)), _cfgs(arch)):
        assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
        assert [tcfg.layer_is_moe(i) for i in range(tcfg.n_layers)] == \
            [jcfg.layer_is_moe(i) for i in range(jcfg.n_layers)]
        assert tcfg.param_count() == jcfg.param_count()
        assert tcfg.active_param_count() == jcfg.active_param_count()


def test_top_k_orders_ties_by_lower_index():
    probs = torch.tensor([[0.25, 0.5, 0.25, 0.0], [0.1, 0.3, 0.3, 0.3]])
    vals, idx = moe._top_k(probs, 2)
    jvals, jidx = jax.lax.top_k(jnp.asarray(probs.numpy()), 2)
    assert idx.tolist() == np.asarray(jidx).tolist() == [[1, 0], [1, 2]]
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jvals))


# ------------------------------------------------------------- moe_apply --

@pytest.mark.parametrize("packed", [False, True], ids=["dense", "mip2q"])
def test_moe_apply_matches_reference(arch_params, packed):
    arch, _, _ = arch_params
    jcfg, tcfg = _cfgs(arch)
    jp = referee.jax_params({"blocks": {"moe": jmoe.moe_def(jcfg)}}, 1)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    if packed:
        scfg = dict(method="mip2q", p=0.5, L=5)
        jcfg = dataclasses.replace(jcfg, strum=JCfg(**scfg))
        tcfg = dataclasses.replace(tcfg, strum=TCfg(**scfg))
        jp = jengine.build_plan(jp, cfg=jcfg.strum).params
        tp = engine.build_plan(tp, cfg=tcfg.strum, device="cpu").params
    x = np.random.default_rng(2).normal(size=(2, 16, jcfg.d_model)).astype(np.float32)
    jy, jaux = jmoe.moe_apply(jp["blocks"]["moe"], jnp.asarray(x), jcfg)
    ty, taux = moe.moe_apply(tp["blocks"]["moe"], torch.from_numpy(x), tcfg,
                             backend="reference")   # ignored, as the reference does
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=AUX_RTOL)
    assert float(taux) > 0
    # a mesh without a "model" axis serves the local path, as the reference's
    # does (the expert-parallel body is tests/test_torch_distributed.py's)
    ty2, taux2 = moe.moe_apply(tp["blocks"]["moe"], torch.from_numpy(x), tcfg,
                               mesh=object())
    assert torch.equal(ty2, ty) and torch.equal(taux2, taux)


# --------------------------------------------------------------- forwards --

def _set(tree, name, leaf):
    keys = name.split("/")
    for k in keys[:-1]:
        tree = tree[k]
    tree[keys[-1]] = leaf


def _served(jparams, tparams, plan_kw):
    """(reference served tree, port served tree, port plan) for one plan:
    the port packs, the reference serves the port's payloads."""
    if plan_kw is None:
        return jparams, tparams, None
    tplan = engine.build_plan(tparams, cfg=TCfg(**plan_kw), device="cpu")
    jplan = jengine.build_plan(jparams, cfg=JCfg(**plan_kw), pack=False)
    assert sorted(jplan.entries) == sorted(tplan.entries)
    jserved = jax.tree.map(lambda a: a, jparams)
    for name, entry in jplan.entries.items():
        leaf = {f: jnp.asarray(tplan[name].leaf[f].numpy()) for f in FIELDS}
        _set(jserved, name, dict(leaf, cfg=entry.cfg, spec=entry.spec))
    return jserved, tplan.params, tplan


def _tokens(seed, shape):
    return np.random.default_rng(seed).integers(0, 256, size=shape).astype(np.int32)


@pytest.mark.parametrize("plan", list(PLANS))
def test_forward_logits_and_aux_match_reference(arch_params, plan):
    """forward_train (logits and the summed aux), prefill and teacher-forced
    decode steps; decode through the caches equals the full forward (the
    smoke capacity never drops)."""
    arch, jparams, tparams = arch_params
    jcfg, tcfg = _cfgs(arch)
    jserved, tserved, tplan = _served(jparams, tparams, PLANS[plan])
    if tplan is not None:
        assert set(tplan.variants().values()) == {"torch:dequant"}
        assert sum("/moe/" in n for n in tplan.entries) == 3
    seq = _tokens(1, (B, SEQ))
    prompt, teach = seq[:, :PROMPT], seq[:, PROMPT:PROMPT + STEPS]

    def reference(params, seq, prompt, teach):
        full, aux = j_forward(params, {"tokens": seq}, jcfg)
        lg, caches = j_prefill(params, {"tokens": prompt}, jcfg)
        caches = j_pad_caches(caches, STEPS)
        steps = [lg[:, -1]]
        for i in range(STEPS):
            lg, caches = j_decode_step(params, teach[:, i:i + 1], caches,
                                       jnp.int32(PROMPT + i), jcfg)
            steps.append(lg[:, -1])
        return full, aux, jnp.stack(steps, axis=1)
    j_full, j_aux, j_steps = jax.jit(reference)(jserved, seq, prompt, teach)

    t_full, t_aux = forward_train(tserved, {"tokens": torch.from_numpy(seq).long()}, tcfg)
    lg, caches = prefill(tserved, {"tokens": torch.from_numpy(prompt).long()}, tcfg)
    caches = pad_caches(caches, STEPS)
    t_steps = [lg[:, -1]]
    for i in range(STEPS):
        lg, caches = decode_step(tserved, torch.from_numpy(teach[:, i:i + 1]).long(),
                                 caches, PROMPT + i, tcfg)
        t_steps.append(lg[:, -1])
    t_steps = torch.stack(t_steps, 1).numpy()
    np.testing.assert_allclose(t_full.numpy(), np.asarray(j_full), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(float(t_aux), float(j_aux), rtol=AUX_RTOL)
    assert float(t_aux) > 0
    np.testing.assert_allclose(t_steps, np.asarray(j_steps), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(t_steps, t_full[:, PROMPT - 1:PROMPT + STEPS].numpy(),
                               rtol=RTOL, atol=ATOL)


def test_greedy_tokens_teacher_forced_against_reference_serve(arch_params):
    """Greedy tokens of ``repro.launch.serve.serve`` are compared position by
    position, teacher-forced, with the port's predictions; a disagreement is
    allowed only at a near tie (the two tokens' logits within 1e-4)."""
    arch, jparams, tparams = arch_params
    jcfg, tcfg = _cfgs(arch)
    kw = PLANS["mip2q_p0.5"]
    jserved, tserved, _ = _served(jparams, tparams, kw)
    prompt = _tokens(2, (B, PROMPT))
    gen = 6
    j_toks, _, _ = j_serve(dataclasses.replace(jcfg, strum=JCfg(**kw)), jserved,
                           jnp.asarray(prompt), gen, {})
    j_toks = np.asarray(j_toks)
    seq = np.concatenate([prompt, j_toks[:, :gen]], axis=1)
    lg, _ = forward_train(tserved, {"tokens": torch.from_numpy(seq).long()}, tcfg)
    lg = lg[:, PROMPT - 1:, :tcfg.vocab_size].numpy()
    pred = lg.argmax(-1)
    for b, t in zip(*np.nonzero(pred != j_toks)):
        assert lg[b, t, pred[b, t]] - lg[b, t, j_toks[b, t]] < 1e-4, (b, t)
    toks, _, _ = serve(dataclasses.replace(tcfg, strum=TCfg(**kw)), tserved,
                       torch.from_numpy(prompt).long(), gen, device="cpu")
    seq = torch.cat([torch.from_numpy(prompt).long(), toks[:, :gen]], dim=1)
    lg, _ = forward_train(tserved, {"tokens": seq}, tcfg)
    assert torch.equal(lg[:, PROMPT - 1:, :tcfg.vocab_size].argmax(-1), toks)


# ---------------------------------------------------------- paged serving --

LENS, NEW = (8, 21, 5), 10


def _record(sched, vocab):
    """Keep every request's logits in the order its tokens come out (the
    prefill's first token, then each decode tick)."""
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


#: the paged cases: (KV codec, logits tolerance) by id
PAGED = {"fp": (None, dict(rtol=1e-4, atol=1e-5)),
         "mip2q_L7": (dict(method="mip2q", p=0.5, L=7), dict(rtol=1e-3, atol=2e-3))}
PAGED_WEIGHTS = dict(method="mip2q", p=0.5, L=5)


def _paged_run(sched_cls, req_cls, cfg, params, as_prompt, **extra):
    """One scheduler serves three teacher-forced requests on two slots;
    returns it and its per-request logits."""
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, 256, size=(n,)).astype(np.int32) for n in LENS]
    forced = [rng.integers(0, 256, size=(NEW,)).tolist() for _ in LENS]
    sched = sched_cls(cfg, params, n_slots=2, max_len=48, **extra)
    rec = _record(sched, cfg.vocab_size)
    for i, (p, f) in enumerate(zip(prompts, forced)):
        sched.submit(req_cls(uid=i, prompt=as_prompt(p), max_new_tokens=NEW,
                             force_tokens=f))
    done = {r.uid: r for r in sched.run_to_completion(max_steps=500)}
    assert sorted(done) == [0, 1, 2]
    return sched, rec


def _reference_paged(path: str) -> None:
    """The reference's half of the paged cases, run by
    ``_torch_ranks.pinned_reference`` in a process of its own: Moonshot's
    smoke weights (one numpy generator, seed 0), the payloads the port
    packed from them, and per case every
    request's logits, its attention variant and its tick count."""
    jcfg, tcfg = _cfgs("moonshot_v1_16b_a3b")
    host = referee.numpy_params(j_model_defs(jcfg), 0)
    jparams = jax.tree.map(jnp.asarray, host)
    tparams = params_from_numpy(host, device="cpu")
    jserved, _, tplan = _served(jparams, tparams, PAGED_WEIGHTS)
    jcfg = dataclasses.replace(jcfg, strum=JCfg(**PAGED_WEIGHTS))
    out = {f"w/{k}": v for k, v in ranks.flatten(host).items()}
    out.update({f"pk/{name}/{f}": tplan[name].leaf[f].numpy()
                for name in tplan.entries for f in FIELDS})
    for cid, (codec, _) in PAGED.items():
        extra = {} if codec is None else dict(kv_cache=JCfg(**codec),
                                              cache_backend="interpret")
        sched, rec = _paged_run(JSched, JReq, jcfg, jserved, jnp.asarray, **extra)
        out.update({f"{cid}/rec/{uid}": np.stack(rows) for uid, rows in rec.items()})
        out[f"{cid}/attn_variant"] = np.array(sched.spec.attn_variant)
        out[f"{cid}/steps"] = np.array(sched._steps)
    np.savez(path, **out)


@pytest.fixture(scope="module")
def moonshot_reference(tmp_path_factory):
    """The reference's half of the paged cases, from one pinned subprocess:
    what ran earlier in this process cannot move it."""
    path = str(tmp_path_factory.mktemp("ref") / "moonshot.npz")
    ranks.pinned_reference("test_torch_moe", "_reference_paged", path, ROOT)
    return dict(np.load(path))


def _weights(ref: dict, defs, prefix: str = "w") -> dict:
    """Saved reference weights as a nested dict shaped like ``defs`` (empty
    sub-trees kept)."""
    if not isinstance(defs, dict):
        return ref[prefix]
    return {k: _weights(ref, v, f"{prefix}/{k}") for k, v in defs.items()}


@pytest.mark.parametrize("codec,tol", list(PAGED.values()), ids=list(PAGED))
def test_paged_scheduler_matches_reference_per_position(moonshot_reference, codec, tol):
    """Both schedulers serve three requests on two slots (slot recycling;
    parked slots ride the decode batch through the experts on both sides),
    teacher-forced, on packed mip2q weights; every position's logits agree.
    The reference's half runs in a pinned process of its own
    (``_torch_ranks.pinned_reference``); both halves serve the same
    weights and the same packed payloads (the port's packing here equals
    the one the reference's half served, bit for bit)."""
    from repro_torch.models import model_defs
    ref = moonshot_reference
    cid = next(k for k, v in PAGED.items() if v == (codec, tol))
    _, tcfg = _cfgs("moonshot_v1_16b_a3b")
    tparams = params_from_numpy(_weights(ref, model_defs(tcfg)), device="cpu")
    tplan = engine.build_plan(tparams, cfg=TCfg(**PAGED_WEIGHTS), device="cpu")
    packed = {k[len("pk/"):] for k in ref if k.startswith("pk/")}
    assert packed == {f"{name}/{f}" for name in tplan.entries for f in FIELDS}
    for name in tplan.entries:
        for f in FIELDS:
            np.testing.assert_array_equal(tplan[name].leaf[f].numpy(),
                                          ref[f"pk/{name}/{f}"], err_msg=f"{name}/{f}")
    tserved = tplan.params
    tcfg = dataclasses.replace(tcfg, strum=TCfg(**PAGED_WEIGHTS))
    extra = dict(device="cpu") if codec is None else dict(
        device="cpu", kv_cache=TCfg(**codec), cache_backend="cuda")
    tsched, trec = _paged_run(BatchScheduler, Request, tcfg, tserved, torch.from_numpy,
                              **extra)
    assert tsched.spec.attn_variant == str(ref[f"{cid}/attn_variant"])
    assert tsched._steps == int(ref[f"{cid}/steps"])
    for uid in range(len(LENS)):
        want = ref[f"{cid}/rec/{uid}"]
        assert len(want) == len(trec[uid]) == NEW
        np.testing.assert_allclose(np.stack(trec[uid]), want, **tol,
                                   err_msg=f"request {uid}")


def test_moe_serve_entry_points_on_cpu(capsys):
    from repro_torch.launch import serve as S
    assert S.main(["--arch", "moonshot_v1_16b_a3b", "--smoke", "--device", "cpu",
                   "--gen", "3", "--prompt-len", "8"]) == 0
    out = capsys.readouterr().out
    assert "variants {'torch:dequant': 7}" in out
    assert S.main(["--arch", "moonshot_v1_16b_a3b", "--smoke", "--device", "cpu",
                   "--paged", "--kv-cache", "dliq", "--gen", "3",
                   "--prompt-len", "20"]) == 0
    out = capsys.readouterr().out
    assert "x0.8750 vs int8 pages" in out and "4 requests" in out
