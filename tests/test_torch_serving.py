"""The port's paged serving runtime against the JAX reference scheduler.

Both ``BatchScheduler``s serve the same requests on the same weights
(reference params carried across through numpy), teacher-forced on one
seeded token sequence, and every position's logits are compared: the first
token's (from the prefill lane) and each decode tick's.  Smoke ``olmo_1b``
(MHA) and ``qwen2_7b`` with ``n_kv_heads=2`` (GQA, rep 2: the smoke config
of ``tiny_variant`` has 4 query and 4 kv heads), f32 activations, pages of
16, two slots for three requests (slot recycling), prompts that seal pages
during prefill and decodes that seal them during decode.

Tolerances.  Fp pages: rtol 1e-4, atol 1e-5 (f32 sums in another order).
Packed pages (dliq q=4, mip2q L=7; the port's ``cache_backend="cuda"`` runs
K4's plain version on CPU tensors, the reference ``"interpret"``): rtol
1e-3, atol 2e-3.  The pools cannot be held byte-identical: the reference
seals under ``jax.jit``, where ``amax / 127`` becomes a reciprocal
multiply, and the K/V it seals vary in their last bits from run to run
(XLA's CPU reductions), so a value on a rounding boundary can take the
neighbouring code.  Three runs of the four packed cases on a CPU printed:
scales differing by at most 9-19 ulps, in 0.31-0.37 of them; payload bytes
differing in one case of twelve (4.65e-5 of them); max |logit diff| 8.9e-7
to 2.2e-6.  The test prints both counts for every case and bounds them at
64 ulps and 1e-3 of the bytes.  The reference's half of the packed cases
runs in a process of its own whose state is pinned
(``_torch_ranks.pinned_reference``: single-threaded XLA, no
``STRUM_INTERPRET``), on weights drawn from one numpy generator (seed 0,
the reference's init scales: ``_torch_f64_referee.numpy_params``; the
reference's ``init_params`` keys leaves by ``hash(name)``, so its draw
changes with the process's hash salt) and carried to the port, so the
comparison depends neither on what ran earlier in the test's process nor
on its hash salt.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_smoke_config as j_smoke
from repro.core.policy import StruMConfig as JCfg
from repro.models import model_defs as j_model_defs
from repro.serving import BatchScheduler as JSched
from repro.serving import Request as JReq
from repro_torch.configs.base import get_smoke_config as t_smoke
from repro_torch.core.policy import StruMConfig as TCfg
from repro_torch.models import model_defs
from repro_torch.models.params import init_params, params_from_numpy
from repro_torch.serving import BatchScheduler, PagesExhausted, Request

import _torch_f64_referee as referee
import _torch_ranks as ranks

torch.set_num_threads(1)  # xdist runs several workers side by side: one intra-op thread each

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-4, atol=1e-5)
PACKED_TOL = dict(rtol=1e-3, atol=2e-3)
LENS, NEW = (8, 21, 5), 12


def _cfgs(arch):
    over = dict(dtype="float32")
    if arch == "qwen2_7b":
        over["n_kv_heads"] = 2
    return (dataclasses.replace(j_smoke(arch), **over),
            dataclasses.replace(t_smoke(arch), **over))


@pytest.fixture(scope="module", params=["olmo_1b", "qwen2_7b"])
def arch(request):
    jcfg, tcfg = _cfgs(request.param)
    jparams = referee.jax_params(j_model_defs(jcfg), 0)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    return jcfg, tcfg, jparams, tparams


def _prompts(lens=LENS, seed=7):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, size=(n,)).astype(np.int32) for n in lens]


def _forced(n, seed=9):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, size=(NEW,)).tolist() for _ in range(n)]


def _record(sched, vocab):
    """Wrap a scheduler's lanes so every request's logits are kept in the
    order its tokens come out: the prefill's first token, then each decode
    tick.  Works on both schedulers (their lanes have the same contract)."""
    rec: dict = {}
    decode, chunk, serial = sched._decode, sched._chunk_prefill, sched._prefill

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

    def ser(params, batch):
        lg, caches = serial(params, batch)
        [sl] = [s for s in sched.slots if s is not None and s.state == "prefill"
                and s.len == 0]
        add(sl.req.uid, lg[0, -1])
        return lg, caches
    sched._decode, sched._chunk_prefill, sched._prefill = dec, chk, ser
    return rec


def _serve_one(sched_cls, req_cls, cfg, params, as_prompt, max_len=48, **kw):
    """One scheduler serves the three teacher-forced requests; returns it
    and its per-request logits."""
    prompts, forced = _prompts(), _forced(len(LENS))
    sched = sched_cls(cfg, params, n_slots=2, max_len=max_len, **kw)
    rec = _record(sched, cfg.vocab_size)
    for i, (p, f) in enumerate(zip(prompts, forced)):
        sched.submit(req_cls(uid=i, prompt=as_prompt(p), max_new_tokens=NEW,
                             force_tokens=f))
    done = {r.uid: r for r in sched.run_to_completion(max_steps=500)}
    assert sorted(done) == [0, 1, 2] and all(len(r.output) == NEW
                                             for r in done.values())
    return sched, rec


def _serve_both(arch, max_len=48, j_kw=None, t_kw=None, **kw):
    jcfg, tcfg, jparams, tparams = arch
    return [_serve_one(JSched, JReq, jcfg, jparams, jnp.asarray, max_len,
                       **kw, **(j_kw or {})),
            _serve_one(BatchScheduler, Request, tcfg, tparams, torch.from_numpy,
                       max_len, **kw, **dict(t_kw or {}, device="cpu"))]


def _compare_logits(ref, port, tol):
    """Assert per-position agreement; returns the largest |difference|."""
    assert sorted(ref) == sorted(port) == [0, 1, 2]
    worst = 0.0
    for uid in ref:
        assert len(ref[uid]) == len(port[uid]) == NEW
        got, want = np.stack(port[uid]), np.stack(ref[uid])
        np.testing.assert_allclose(got, want, **tol, err_msg=f"request {uid}")
        worst = max(worst, float(np.abs(got - want).max()))
    return worst


@pytest.mark.parametrize("prefill", ["chunked", "serial"])
def test_fp_pages_match_reference_per_position(arch, prefill):
    (jsched, jrec), (tsched, trec) = _serve_both(arch, prefill=prefill)
    assert tsched.spec.variant == jsched.spec.variant == "cache:fp_passthrough"
    _compare_logits(jrec, trec, TOL)
    assert tsched._steps == jsched._steps
    assert tsched.lane_runs["prefill_chunk" if prefill == "chunked"
                            else "prefill_serial"] > 0


def _pool_diffs(jpools: dict, tsched):
    """Over every pool field after both runs (the reference's as
    ``{"pos/k|v/field": array}``): the largest scale difference in ulps,
    the share of scales that differ, and the share of payload bytes that
    differ."""
    ulps, scales, n_scales, codes, n_codes = 0, 0, 0, 0, 0
    for pos, pool in tsched.pools.items():
        for name in ("k", "v"):
            for key, t in pool[name].items():
                a, b = t.numpy(), jpools[f"{pos}/{name}/{key}"]
                if key == "scale":
                    d = np.abs(a.view(np.int32).astype(np.int64)
                               - b.view(np.int32).astype(np.int64))
                    ulps = max(ulps, int(d.max()))
                    scales += int((d > 0).sum())
                    n_scales += a.size
                else:
                    codes += int((a != b).sum())
                    n_codes += a.size
    return ulps, scales / n_scales, codes / n_codes


#: the packed-page cases: (codec, max_len) by id
PACKED = {"dliq_q4": (dict(method="dliq", p=0.5, q=4), 48),
          "mip2q_L7_ragged_window": (dict(method="mip2q", p=0.5, L=7), 40)}  # max_len % page_size != 0


def _reference_packed(path: str, arch: str) -> None:
    """The reference's half of the packed-page cases, run by
    ``_torch_ranks.pinned_reference`` in a process of its own: its weights
    (one numpy generator, seed 0) and, per case, every request's logits,
    the pools it sealed, and its attention variant, into ``path``."""
    jcfg, _ = _cfgs(arch)
    jparams = jax.tree.map(jnp.asarray, referee.numpy_params(j_model_defs(jcfg), 0))
    out = {f"w/{k}": v for k, v in ranks.flatten(jax.tree.map(np.asarray, jparams)).items()}
    for cid, (codec, max_len) in PACKED.items():
        sched, rec = _serve_one(JSched, JReq, jcfg, jparams, jnp.asarray, max_len,
                                kv_cache=JCfg(**codec), cache_backend="interpret")
        out.update({f"{cid}/rec/{uid}": np.stack(rows) for uid, rows in rec.items()})
        out.update({f"{cid}/pool/{pos}/{name}/{key}": np.asarray(a)
                    for pos, pool in sched.pools.items() for name in ("k", "v")
                    for key, a in pool[name].items()})
        out[f"{cid}/attn_variant"] = np.array(sched.spec.attn_variant)
    np.savez(path, **out)


@pytest.fixture(scope="module")
def packed_reference(tmp_path_factory):
    """``arch -> the reference's half of the packed cases`` (one pinned
    subprocess per arch, on first use)."""
    cache: dict = {}

    def get(arch: str) -> dict:
        if arch not in cache:
            path = str(tmp_path_factory.mktemp("ref") / f"{arch}.npz")
            ranks.pinned_reference("test_torch_serving", "_reference_packed", path,
                                   ROOT, arch)
            cache[arch] = dict(np.load(path))
        return cache[arch]
    return get


@pytest.mark.parametrize("codec,max_len", list(PACKED.values()), ids=list(PACKED))
def test_packed_pages_match_reference_per_position(arch, packed_reference, codec,
                                                   max_len):
    """The reference's half runs in a process of its own with its state
    pinned (``_torch_ranks.pinned_reference``), so what ran earlier in this
    process cannot move its pools; both halves serve its weights."""
    tcfg = arch[1]
    name = tcfg.name[:-len("_smoke")]
    cid = next(k for k, v in PACKED.items() if v == (codec, max_len))
    ref = packed_reference(name)
    tparams = params_from_numpy(_weights(ref, model_defs(tcfg)), device="cpu")
    tsched, trec = _serve_one(BatchScheduler, Request, tcfg, tparams, torch.from_numpy,
                              max_len, kv_cache=TCfg(**codec), cache_backend="cuda",
                              device="cpu")
    jrec = {uid: list(ref[f"{cid}/rec/{uid}"]) for uid in range(len(LENS))}
    assert str(ref[f"{cid}/attn_variant"]) == tsched.spec.attn_variant == "cache:attn_fused"
    assert tsched.spec.variant == "cache:cuda_decode"
    worst = _compare_logits(jrec, trec, PACKED_TOL)
    pre = f"{cid}/pool/"
    ulps, scale_share, code_share = _pool_diffs(
        {k[len(pre):]: v for k, v in ref.items() if k.startswith(pre)}, tsched)
    print(f"\npools: scales differ by <= {ulps} ulps ({scale_share:.3f} of them), "
          f"{code_share:.2e} of payload bytes differ; max |logit diff| {worst:.2e}")
    assert ulps <= 64 and code_share < 1e-3
    st = tsched.cache_stats()
    assert st["resident_page_bytes"] == st["expected_page_bytes"]
    assert st["ratio_vs_int8"] == pytest.approx(TCfg(**codec).compression_ratio)
    assert st["ratio_vs_int8"] == pytest.approx(0.875)


def _weights(ref: dict, defs, prefix: str = "w") -> dict:
    """The reference's weights of a saved half, as a nested dict of numpy
    arrays shaped like ``defs`` (empty sub-trees, e.g. OLMo's parameter-free
    norms, kept)."""
    if not isinstance(defs, dict):
        return ref[prefix]
    return {k: _weights(ref, v, f"{prefix}/{k}") for k, v in defs.items()}


# ------------------------------------------------------------- edge cases --
#
# tests/test_serving_runtime.py's scheduler edge cases, on the port alone.

@pytest.fixture(scope="module")
def tiny():
    _, tcfg = _cfgs("qwen2_7b")
    return tcfg, init_params(model_defs(tcfg), seed=0, device="cpu",
                             dtype_override="float32")


def _run(tiny, reqs, **kw):
    cfg, params = tiny
    kw.setdefault("n_slots", 2)
    kw.setdefault("max_len", 48)
    sched = BatchScheduler(cfg, params, device="cpu", **kw)
    for r in reqs:
        sched.submit(r)
    return {r.uid: r for r in sched.run_to_completion(max_steps=500)}, sched


def _p(n, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).integers(0, 256, size=(n,)))


def test_eos_on_first_decoded_token(tiny):
    pr = _p(8)
    done, _ = _run(tiny, [Request(uid=0, prompt=pr, max_new_tokens=4)])
    tok0 = done[0].output[0]
    done, sched = _run(tiny, [Request(uid=0, prompt=pr, max_new_tokens=8, eos_id=tok0),
                              Request(uid=1, prompt=pr, max_new_tokens=3)])
    assert done[0].output == [tok0] and done[0].done
    assert len(done[1].output) == 3
    assert sched.allocator.available == sched.allocator.n_pages


def test_max_new_tokens_zero(tiny):
    done, sched = _run(tiny, [Request(uid=0, prompt=_p(8), max_new_tokens=0),
                              Request(uid=1, prompt=_p(8), max_new_tokens=2)])
    assert done[0].output == [] and done[0].done and len(done[1].output) == 2
    assert sched.allocator.available == sched.allocator.n_pages


def test_page_and_slot_exhaustion_queue_requests(tiny):
    reqs = [Request(uid=i, prompt=_p(n, i), max_new_tokens=4)
            for i, n in enumerate((8, 11, 6, 8))]
    done, sched = _run(tiny, reqs, n_pages=1)         # pages gate admission
    assert sorted(done) == [0, 1, 2, 3] and all(len(r.output) == 4
                                                for r in done.values())
    assert sched.allocator.available == 1
    reqs = [Request(uid=i, prompt=_p(8, i), max_new_tokens=4) for i in range(5)]
    done, _ = _run(tiny, reqs)                        # 2 slots, 5 requests
    assert sorted(done) == [0, 1, 2, 3, 4]


def test_submit_rejects_impossible_requests(tiny):
    cfg, params = tiny
    sched = BatchScheduler(cfg, params, n_slots=1, max_len=32, n_pages=1, device="cpu")
    with pytest.raises(ValueError, match="does not fit"):
        sched.submit(Request(uid=0, prompt=_p(40), max_new_tokens=4))
    with pytest.raises(PagesExhausted, match="pool"):
        sched.submit(Request(uid=1, prompt=_p(20), max_new_tokens=8))
    assert not sched.queue
    sched.submit(Request(uid=2, prompt=_p(6), max_new_tokens=2))
    done = sched.run_to_completion(max_steps=100)
    assert len(done) == 1 and len(done[0].output) == 2
    with pytest.raises(ValueError, match="speculative"):
        BatchScheduler(cfg, params, speculative=2, device="cpu")


def test_priority_admission(tiny):
    cfg, params = tiny
    sched = BatchScheduler(cfg, params, n_slots=1, max_len=48, device="cpu")
    sched.submit(Request(uid=0, prompt=_p(8), max_new_tokens=4, priority=0))
    sched.submit(Request(uid=1, prompt=_p(11), max_new_tokens=4, priority=5))
    assert [r.uid for r in sched.run_to_completion(max_steps=300)] == [1, 0]


@pytest.mark.parametrize("kv", [None, TCfg(method="dliq", p=0.5, q=4)], ids=["fp", "dliq"])
def test_slot_recycling_cache_isolation(tiny, kv):
    """A retired request's pages must not leak into its successor."""
    pa, pb = _p(20, 3), _p(9, 4)
    recycled, _ = _run(tiny, [Request(uid=0, prompt=pa, max_new_tokens=8),
                              Request(uid=1, prompt=pb, max_new_tokens=8)],
                       n_slots=1, kv_cache=kv, cache_backend="cuda")
    fresh, _ = _run(tiny, [Request(uid=1, prompt=pb, max_new_tokens=8)], n_slots=1,
                    kv_cache=kv, cache_backend="cuda")
    assert recycled[1].output == fresh[1].output


def test_paged_serve_entry_point_on_cpu(capsys):
    from repro_torch.launch import serve
    assert serve.main(["--arch", "olmo_1b", "--smoke", "--device", "cpu", "--paged",
                       "--kv-cache", "dliq", "--gen", "4", "--prompt-len", "20"]) == 0
    out = capsys.readouterr().out
    assert "codec cache:cuda_decode" not in out and "cache:torch_dequant" in out
    assert "x0.8750 vs int8 pages" in out and "4 requests" in out
