"""The port's self-speculative lane against the JAX reference.

* ``verify_chunk_step`` (``verify_attention_paged``: sealed pages + the hot
  tail's committed rows + the causal window) on the same pools, tails and
  page table as the reference's, with packed dliq and mip2q pages, GQA (rep
  2) and a ``start`` that is not page-aligned.  Tail rows at or after
  ``start`` hold large values, which must not change anything.  Logits and
  window KV at rtol 1e-3 / atol 2e-3, the tolerance of the packed-page
  serving tests (the port's K4 plain version against the reference's K4 in
  interpret mode).
* ``tests/test_speculative.py``'s five scheduler cases, mirrored: the same
  ``qwen2_7b`` smoke config in f32, weights carried across through numpy,
  ``n_slots=2, max_len=48, page_size=16``.  The port's speculative outputs
  must equal the port's plain outputs and the reference's speculative
  outputs token for token; its ``spec/*`` counters must equal the
  reference's; and after every round each slot's tails must equal the
  reference's (rtol 1e-4 / atol 1e-5, the fp tolerance of the serving
  tests: both sides compute the same KV rows in f32).  Without the
  port's tail snapshot the draft lane's provisional rows would stay in the
  tails, so the last check is what proves the rollback.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import engine as jengine
from repro import telemetry as jtelemetry
from repro.configs.base import get_smoke_config as j_smoke
from repro.core.policy import StruMConfig as JCfg
from repro.models import model_defs as j_model_defs
from repro.models import transformer as jtfm
from repro.serving import BatchScheduler as JSched
from repro.serving import Request as JReq
from repro.serving import pages as jpages
from repro_torch import engine, telemetry
from repro_torch.configs.base import get_smoke_config as t_smoke
from repro_torch.core.policy import StruMConfig as TCfg
from repro_torch.models import transformer as tfm
from repro_torch.models.params import params_from_numpy
from repro_torch.serving import BatchScheduler, Request
from repro_torch.serving import pages

import _torch_f64_referee as referee

torch.set_num_threads(1)  # xdist runs several workers side by side: one intra-op thread each

PACKED_TOL = dict(rtol=1e-3, atol=2e-3)
TAIL_TOL = dict(rtol=1e-4, atol=1e-5)
WCFGS = [("dliq_q4", dict(method="dliq", w=16, p=0.5, q=4)),
         ("mip2q_L5", dict(method="mip2q", w=16, p=0.5, L=5))]


def _np(t):
    """A copy: the port writes its tails in place."""
    return t.numpy().copy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _to_jax(tree):
    if isinstance(tree, dict):
        return {k: _to_jax(v) for k, v in tree.items()}
    return jnp.asarray(tree.numpy())


def _arch(**over):
    over["dtype"] = "float32"
    jcfg = dataclasses.replace(j_smoke("qwen2_7b"), **over)
    tcfg = dataclasses.replace(t_smoke("qwen2_7b"), **over)
    jparams = referee.jax_params(j_model_defs(jcfg), 0)
    return jcfg, tcfg, jparams, params_from_numpy(jax.tree.map(np.asarray, jparams),
                                                  device="cpu")


# ------------------------------------------------------------ verify step --

@pytest.fixture(scope="module")
def gqa():
    return _arch(n_kv_heads=2)


@pytest.mark.parametrize("codec,start", [
    (dict(method="dliq", p=0.5, q=4), 37),      # 2 sealed pages + 5 tail rows
    (dict(method="dliq", p=0.5, q=4), 32),      # page-aligned: empty tail part
    (dict(method="mip2q", p=0.5, L=7), 21),     # 1 sealed page + 5 tail rows
], ids=["dliq-start37", "dliq-start32", "mip2q-start21"])
def test_verify_chunk_step_matches_reference(gqa, codec, start):
    jcfg, tcfg, jparams, tparams = gqa
    ps, slot, c = 16, 1, 4
    spec = pages.make_cache_spec(tcfg, TCfg(**codec), ps, "cpu", backend="cuda")
    jspec = jpages.make_cache_spec(jcfg, JCfg(**codec), ps, backend="interpret")
    rng = np.random.default_rng(11)
    pools = pages.init_pools(tcfg, 8, spec)
    seal = pages.make_sealer(spec)
    kv_shape = (tfm.n_groups(tcfg), ps, tcfg.n_kv_heads, tcfg.hd)
    for pos in pools:
        for pid in range(6):
            k, v = (torch.from_numpy(rng.normal(size=kv_shape).astype(np.float32))
                    for _ in range(2))
            seal(pools[pos], k, v, pid)
    hot = pages.init_hot(tcfg, 2, ps, "cpu")
    for hp in hot.values():
        for t in hp.values():
            t.copy_(torch.from_numpy(rng.normal(size=t.shape).astype(np.float32)))
            t[:, slot, start % ps:] = 1e3          # stale rows: never score
    table = np.array([[3, 1, -1, -1], [0, 2, 4, -1]], np.int32)
    toks = rng.integers(0, tcfg.vocab_size, size=(1, c))
    before = {pos: {n: t.clone() for n, t in hp.items()} for pos, hp in hot.items()}

    def port(hot_):
        return tfm.verify_chunk_step(tparams, torch.from_numpy(toks), pools, hot_,
                                     torch.from_numpy(table), torch.tensor(slot),
                                     torch.tensor(start), spec, tcfg,
                                     cache_backend="cuda")
    lg, ckv = port(hot)
    want_lg, want_kv = jtfm.verify_chunk_step(
        jparams, jnp.asarray(toks, jnp.int32), _to_jax(pools), _to_jax(hot),
        jnp.asarray(table), jnp.int32(slot), jnp.int32(start), jspec, jcfg,
        cache_backend="interpret")
    assert lg.shape == (1, c, tcfg.padded_vocab)
    np.testing.assert_allclose(lg.numpy(), np.asarray(want_lg), **PACKED_TOL)
    for pos in ckv:
        for n in ("k", "v"):
            np.testing.assert_allclose(ckv[pos][n].numpy(), np.asarray(want_kv[pos][n]),
                                       **PACKED_TOL)
    # nothing was written, and the stale rows did not matter
    for pos, hp in hot.items():
        for n, t in hp.items():
            assert torch.equal(t, before[pos][n])
            t[:, slot, start % ps:] = 0.0
    lg0, _ = port(hot)
    assert torch.equal(lg0, lg)


# --------------------------------------------------------------- scheduler --

@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg, jparams, tparams = _arch()
    plans = {label: (jengine.build_plan(jparams, cfg=JCfg(**c), float_only=True),
                     engine.build_plan(tparams, cfg=TCfg(**c), device="cpu"))
             for label, c in WCFGS}
    return jcfg, tcfg, plans


def _reqs(cls, as_prompt, cfg, n=3, max_new=12, seed=0, **kw):
    rng = np.random.default_rng(seed)
    return [cls(uid=i, prompt=as_prompt(rng.integers(0, cfg.vocab_size,
                                                     size=(5 + 2 * i,)).astype(np.int32)),
                max_new_tokens=max_new, **kw) for i in range(n)]


def _drain(side, setup, label, n_slots=2, max_len=48, speculative=0, draft=None,
           **req_kw):
    """Serve ``_reqs(**req_kw)`` on one side ("ref" or "port"); returns the
    outputs, the spec counters, the tails after every speculative round and
    the scheduler."""
    jcfg, tcfg, plans = setup
    jplan, tplan = plans[label]
    if side == "ref":
        sched = JSched(jcfg, jplan.params, n_slots=n_slots, max_len=max_len,
                       plan=jplan, page_size=16, speculative=speculative, draft=draft)
        reqs, rec_ctx = _reqs(JReq, jnp.asarray, jcfg, **req_kw), jtelemetry.recording
    else:
        sched = BatchScheduler(tcfg, None, n_slots=n_slots, max_len=max_len, plan=tplan,
                               page_size=16, speculative=speculative, draft=draft,
                               device="cpu")
        reqs, rec_ctx = _reqs(Request, torch.from_numpy, tcfg, **req_kw), \
            telemetry.recording
    tails = []
    if speculative:
        run = sched._run_speculative

        def wrapped(active):
            run(active)
            tails.append({pos: {n: _np(t) for n, t in hp.items()}
                          for pos, hp in sched.hot.items()})
        sched._run_speculative = wrapped
    with rec_ctx() as rec:
        for r in reqs:
            sched.submit(r)
        done = sched.run_to_completion(max_steps=500)
    counters = {k: rec.counter(f"spec/{k}") for k in ("drafted", "accepted", "rounds")}
    return {r.uid: list(r.output) for r in done}, counters, tails, sched


def _both(setup, label, **kw):
    """The port's and the reference's speculative runs; asserts that their
    outputs, counters and per-round tails agree, and returns the port's."""
    got, counters, tails, sched = _drain("port", setup, label, **kw)
    want, jcounters, jtails, _ = _drain("ref", setup, label, **kw)
    assert got == want, (got, want)
    assert counters == jcounters, (counters, jcounters)
    assert len(tails) == len(jtails) > 0
    for i, (a, b) in enumerate(zip(tails, jtails)):
        for pos in a:
            for n in a[pos]:
                np.testing.assert_allclose(a[pos][n], b[pos][n], **TAIL_TOL,
                                           err_msg=f"round {i} {pos} {n}")
    return got, counters, sched


@pytest.mark.parametrize("label", [label for label, _ in WCFGS])
@pytest.mark.parametrize("mode", ["histream", "maskfree_p"])
def test_teacher_forced_parity_per_codec(setup, label, mode):
    force = [int(t) for t in np.random.default_rng(3).integers(0, 256, size=(12,))]
    base, _, _, plain = _drain("port", setup, label, force_tokens=force)
    got, counters, sched = _both(setup, label, speculative=2, draft=mode,
                                 force_tokens=force)
    assert got == base
    assert counters["drafted"] > 0
    assert plain.lane_runs["draft"] == plain.lane_runs["verify"] == 0
    assert sched.lane_runs["decode"] == 0 and sched.lane_runs["verify"] > 0
    ratio = {"histream": 10 / 14, "maskfree_p": 8 / 14}[mode]
    assert sched.cache_stats()["speculative"]["ratio"] == ratio


def test_greedy_parity_and_rollback_progress(setup):
    base, _, _, _ = _drain("port", setup, "dliq_q4", max_new=20)
    got, counters, _ = _both(setup, "dliq_q4", speculative=3, draft="maskfree_p",
                             max_new=20)
    assert got == base
    assert counters["drafted"] > 0 and counters["accepted"] < counters["drafted"]


def test_speculative_zero_is_plain_lane(setup):
    got, _, _, sched = _drain("port", setup, "dliq_q4", n=1, max_new=4, speculative=0)
    want, _, _, _ = _drain("ref", setup, "dliq_q4", n=1, max_new=4, speculative=0)
    assert got == want
    assert sched.draft_plan is None and sched._draft_decode is None
    assert sched._verify is None and "speculative" not in sched.cache_stats()
    assert sched.lane_runs["draft"] == sched.lane_runs["verify"] == 0


def test_eos_inside_accepted_prefix_retires(setup):
    base, _, _, _ = _drain("port", setup, "dliq_q4", n=2, max_new=10)
    eos = base[0][3]
    b2, _, _, _ = _drain("port", setup, "dliq_q4", n=2, max_new=10, eos_id=eos)
    got, _, _ = _both(setup, "dliq_q4", n=2, max_new=10, eos_id=eos, speculative=3,
                      draft="histream")
    assert got == b2
    assert len(b2[0]) <= 4 and b2[0][-1] == eos


def test_recycled_slot_isolation_under_rollback(setup):
    base, _, _, _ = _drain("port", setup, "dliq_q4", n=5, max_new=6)
    got, _, _ = _both(setup, "dliq_q4", n=5, max_new=6, speculative=2,
                      draft="maskfree_p")
    assert got == base
    assert sorted(got) == [0, 1, 2, 3, 4]


def test_speculative_needs_a_plan_and_serves_from_the_entry_point(capsys):
    _, tcfg, _, tparams = _arch()
    with pytest.raises(ValueError, match="needs a weight plan"):
        BatchScheduler(tcfg, tparams, speculative=2, device="cpu")
    from repro_torch.launch import serve
    with pytest.raises(ValueError, match="needs --paged"):
        serve.run(["--arch", "olmo_1b", "--smoke", "--device", "cpu",
                   "--speculative", "2"])
    assert serve.main(["--arch", "olmo_1b", "--smoke", "--device", "cpu", "--paged",
                       "--kv-cache", "dliq", "--gen", "6", "--prompt-len", "20",
                       "--speculative", "3", "--draft", "maskfree_p"]) == 0
    out = capsys.readouterr().out
    assert "speculative: k=3 draft=maskfree_p acceptance" in out
    assert "payload ratio 0.5714" in out and "4 requests" in out
