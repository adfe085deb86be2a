"""The port's paged runtime on the SSM families (Mamba-2 and the Jamba
hybrid smoke configs) against the JAX reference.

Both ``BatchScheduler``s serve the same prompts (lengths 7 and 18, 5 new
tokens each, two slots) on the same f32 weights (reference params carried
across through numpy): the port's serial and chunked lanes give the
reference scheduler's tokens exactly.  ``cache_stats`` equals the
reference's dict (codec names mapped xla -> torch), and ``init_hot`` /
``init_pools`` the reference's shapes and dtypes (SSM positions: ``conv``
in the activation dtype, ``state`` in f32, no pages).  ``speculative=``
and ``verify_chunk_step`` refuse SSM stacks as the reference does.

Beyond the reference: a recycled slot starts its next request from a zero
conv window and state (the reference's chunked lane continues from the
last request's), so with three prompts on two slots the port's serial and
chunked lanes still agree; the hybrid with packed mip2q pages gives the
same tokens through K4's plain version (``cache_backend="cuda"`` on CPU
tensors) as through the unfused torch family.
"""
import dataclasses

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
from repro.serving import pages as j_pages
from repro_torch import engine
from repro_torch.configs.base import get_smoke_config as t_smoke
from repro_torch.core.policy import StruMConfig as TCfg
from repro_torch.models import transformer as tfm
from repro_torch.models.params import params_from_numpy
from repro_torch.serving import BatchScheduler, Request
from repro_torch.serving import pages as t_pages

import _torch_f64_referee as referee

torch.set_num_threads(1)  # xdist runs several workers side by side: one intra-op thread each

ARCHS = ["mamba2_780m", "jamba_1_5_large_398b"]
LENS, NEW = (7, 18), 5
PAGE_CFG = dict(method="mip2q", p=0.5, L=7)


def _cfgs(arch):
    return (dataclasses.replace(j_smoke(arch), dtype="float32"),
            dataclasses.replace(t_smoke(arch), dtype="float32"))


@pytest.fixture(scope="module", params=ARCHS)
def arch(request):
    jcfg, tcfg = _cfgs(request.param)
    jparams = referee.jax_params(j_model_defs(jcfg), 0)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    return jcfg, tcfg, jparams, tparams


def _prompts(lens=LENS, seed=5):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, size=(n,)).astype(np.int32) for n in lens]


def _serve(sched, req_cls, as_prompt, lens=LENS):
    for i, p in enumerate(_prompts(lens)):
        sched.submit(req_cls(uid=i, prompt=as_prompt(p), max_new_tokens=NEW))
    return {r.uid: list(map(int, r.output)) for r in sched.run_to_completion(max_steps=200)}


@pytest.mark.parametrize("mode", ["serial", "chunked"])
def test_scheduler_tokens_match_reference(arch, mode):
    jcfg, tcfg, jparams, tparams = arch
    want = _serve(JSched(jcfg, jparams, n_slots=2, max_len=48, prefill=mode),
                  JReq, jnp.asarray)
    sched = BatchScheduler(tcfg, tparams, n_slots=2, max_len=48, prefill=mode,
                           device="cpu")
    got = _serve(sched, Request, torch.from_numpy)
    assert len(got) == len(LENS) and all(len(t) == NEW for t in got.values())
    assert got == want, (got, want)
    runs = sched.lane_runs
    assert (runs["prefill_chunk"] > 0) == (mode == "chunked")
    assert (runs["prefill_serial"] > 0) == (mode == "serial")


@pytest.mark.parametrize("kv", [None, PAGE_CFG], ids=["fp", "mip2q"])
def test_cache_stats_match_reference(arch, kv):
    jcfg, tcfg, jparams, tparams = arch
    js = JSched(jcfg, jparams, n_slots=2, max_len=48,
                kv_cache=None if kv is None else JCfg(**kv))
    ts = BatchScheduler(tcfg, tparams, n_slots=2, max_len=48, device="cpu",
                        kv_cache=None if kv is None else TCfg(**kv))
    want = js.cache_stats()
    want["codec"] = want["codec"].replace("xla_", "torch_")
    assert ts.cache_stats() == want
    if tcfg.family == "ssm":
        assert want["n_pages"] == want["resident_page_bytes"] == 0


def _shapes(tree, prefix=""):
    """{path: (shape, dtype name)} of every leaf, either package's tree."""
    if isinstance(tree, dict):
        return {k: v for n, sub in tree.items()
                for k, v in _shapes(sub, f"{prefix}/{n}").items()}
    return {prefix: (tuple(tree.shape), str(tree.dtype).replace("torch.", ""))}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_hot_and_pools_match_reference(dtype):
    for name in ARCHS:
        jcfg, tcfg = (dataclasses.replace(c, dtype=dtype) for c in _cfgs(name))
        assert _shapes(t_pages.init_hot(tcfg, 3, 16, "cpu")) == \
            _shapes(j_pages.init_hot(jcfg, 3, 16))
        spec = t_pages.make_cache_spec(tcfg, TCfg(**PAGE_CFG), 16, "cpu")
        jspec = j_pages.make_cache_spec(jcfg, JCfg(**PAGE_CFG), 16)
        tpools, jpools = t_pages.init_pools(tcfg, 5, spec), j_pages.init_pools(jcfg, 5, jspec)
        assert list(tpools) == list(jpools)
        assert _shapes(tpools) == _shapes(jpools)
        ssm = [i for i in range(tfm.period(tcfg)) if tcfg.layer_kind(i) == "ssm"]
        assert ssm and all(tpools[f"pos{i}"] == {} for i in ssm)


def test_speculative_and_verify_refuse_ssm_stacks(arch):
    jcfg, tcfg, jparams, tparams = arch
    plan = engine.build_plan(tparams, cfg=TCfg(), device="cpu")
    with pytest.raises(ValueError, match="attention-only"):
        BatchScheduler(tcfg, None, plan=plan, speculative=3, device="cpu")
    from repro import engine as jengine
    jplan = jengine.build_plan(jparams, cfg=JCfg())
    with pytest.raises(ValueError, match="attention-only"):
        JSched(jcfg, None, plan=jplan, speculative=3)
    sched = BatchScheduler(tcfg, tparams, n_slots=1, max_len=48, device="cpu")
    with pytest.raises(NotImplementedError, match="attention-only"):
        tfm.verify_chunk_step(sched.params, torch.zeros((1, 4), dtype=torch.long),
                              sched.pools, sched.hot, torch.zeros((1, 3), dtype=torch.int32),
                              torch.tensor(0), torch.tensor(0), sched.spec, tcfg)


def test_recycled_slot_starts_from_zero_state(arch):
    """Three prompts on two slots: the third request reuses a slot whose
    SSM state belongs to a retired request; serial and chunked agree."""
    _, tcfg, _, tparams = arch
    outs = {mode: _serve(BatchScheduler(tcfg, tparams, n_slots=2, max_len=48,
                                        prefill=mode, device="cpu"),
                         Request, torch.from_numpy, lens=(7, 18, 11))
            for mode in ("serial", "chunked")}
    assert len(outs["serial"]) == 3
    assert outs["serial"] == outs["chunked"]


def test_hybrid_packed_pages_plain_k4_matches_torch_family():
    """Jamba smoke with mip2q pages: K4's plain version (the ``cuda`` cache
    backend on CPU tensors) and the torch family give the same tokens, and
    chunked the same as serial."""
    _, tcfg = _cfgs("jamba_1_5_large_398b")
    from repro_torch.models import model_defs
    from repro_torch.models.params import init_params
    params = init_params(model_defs(tcfg), seed=1, device="cpu",
                         dtype_override="float32")
    outs = {}
    for backend, mode in (("cuda", "chunked"), (None, "chunked"), ("cuda", "serial")):
        sched = BatchScheduler(tcfg, params, n_slots=2, max_len=48, prefill=mode,
                               kv_cache=TCfg(**PAGE_CFG), cache_backend=backend,
                               device="cpu")
        outs[backend, mode] = _serve(sched, Request, torch.from_numpy, lens=(21, 9))
        assert sched.cache_stats()["ratio_vs_int8"] == 0.875
    assert sched.spec.attn_variant == "cache:attn_fused"
    first = outs["cuda", "chunked"]
    assert all(o == first for o in outs.values()), outs


def test_serve_entry_point_mamba2_paged_on_cpu(capsys):
    from repro_torch.launch import serve
    assert serve.main(["--arch", "mamba2_780m", "--smoke", "--paged", "--device",
                       "cpu", "--batch", "2", "--prompt-len", "20", "--gen", "3"]) == 0
    out = capsys.readouterr().out
    assert "paged serve: 2 requests" in out and "SSM hot state" in out
    with pytest.raises(ValueError, match="period"):
        serve.run(["--arch", "jamba_1_5_large_398b", "--smoke", "--layers", "3",
                   "--device", "cpu"])
