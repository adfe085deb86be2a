"""The port's training path against the JAX reference on the CPU.

Reference parameters (seeded, f32) carry across to the port through numpy
(``params_from_numpy``), and both packages see the same token batches.

* data: ``global_batch`` / ``host_shard`` equal the reference's token for
  token; host shards partition the global batch.
* loss and gradients, all ten smoke configs at f32 activations: ``loss``,
  ``ce`` and ``aux`` within 1e-5 relative of ``jax.value_and_grad``, every
  leaf's gradient within 1e-4 of its largest |g| (f32 sums in other
  orders, through attention, the SSD scan and the MoE router); at bf16
  activations the loss within 2e-2 relative (bf16 roundings at other
  points of the two graphs); remat "full" and "dots" give the no-remat
  loss and gradients bit for bit (the same ops run again).
* AdamW: three updates from identical state within 1e-6 relative (f32
  elementwise arithmetic; the global norm sums in another order), a
  clipped case, ``warmup_cosine`` over steps 0-200 within 1e-6 relative.
* compression: ``compress_grad`` bit-identical to the reference's eager
  call (shapes that are and are not a multiple of w); against the jitted
  reference, XLA's reciprocal multiply for ``amax / 127`` moves a block's
  scale by one ulp, so there each value is within one ulp of its block's
  scale times 128; error-feedback telescoping and ``payload_ratio``.
* train step: three jitted reference steps of ``sys_tiny``
  (tests/test_system.py's model) against three port steps, chained without
  compression, each started from the reference's state before it with
  compression: metrics within 1e-4 relative; parameters and moments
  within 1e-4 of each leaf's largest value, without compression all of
  them, with compression all but 0.1%, and so the error-feedback residual
  (the codec is discontinuous: see the test).
* learning and PTQ, tests/test_system.py's flow on the port alone: 120
  steps of ``sys_tiny`` cut the loss by 0.5, with and without compression;
  on the trained weights the PTQ CE ordering holds and packed serving agrees
  with dense teacher-forced at > 0.7 of positions.
* the entry point ``launch.train`` runs on the CPU when asked and resumes.
Checkpoints and bit-identical resume are in tests/test_torch_checkpoint.py.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JModelConfig
from repro.configs.base import get_smoke_config as j_smoke
from repro.data import pipeline as jdata
from repro.launch.steps import make_train_step as j_make_train_step
from repro.models import model_defs as j_model_defs
from repro.models.transformer import loss_fn as j_loss_fn
from repro.optim import adamw as jadamw
from repro.runtime import compression as jcomp
from repro_torch.configs.base import ARCH_IDS
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.base import get_smoke_config as t_smoke
from repro_torch.core.apply import _named_leaves
from repro_torch.core.policy import StruMConfig, default_policy
from repro_torch.engine import build_plan, fake_quantize
from repro_torch.data import pipeline as tdata
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.models import forward_train, loss_fn, model_defs
from repro_torch.models.params import init_params, params_from_numpy
from repro_torch.optim import adamw as tadamw
from repro_torch.runtime import compression as tcomp

import _torch_f64_referee as referee

torch.set_num_threads(1)  # xdist runs several workers side by side: one intra-op thread each

SYS = dict(name="sys_tiny", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
           head_dim=16, d_ff=128, vocab_size=256, remat=False, attn_chunk=32)
B, S = 2, 40                      # S > attn_chunk (32): a ragged tail


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _leaves(tree) -> dict:
    """name -> numpy array of a port (torch) or reference (jax) tree."""
    return {n: (x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x))
            for n, x in _named_leaves(tree)}


def _close_per_leaf(got, want, rel):
    """Every leaf within ``rel`` of its own largest |value|."""
    got, want = _leaves(got), _leaves(want)
    assert got.keys() == want.keys()
    for name in want:
        g, w = np.asarray(got[name], np.float64), np.asarray(want[name], np.float64)
        assert g.shape == w.shape, name
        scale = max(float(np.abs(w).max()), 1e-30)
        assert float(np.abs(g - w).max()) <= rel * scale, (name, np.abs(g - w).max(), scale)


def _rel(got, want) -> float:
    return abs(float(got) - float(want)) / max(abs(float(want)), 1e-30)


# ------------------------------------------------------------------ data --

@pytest.mark.parametrize("seed,step", [(1234, 0), (3, 7), (0, 9001)])
def test_data_matches_reference_token_for_token(seed, step):
    jcfg = jdata.DataConfig(vocab_size=50304, seq_len=33, global_batch=8, seed=seed)
    tcfg = tdata.DataConfig(vocab_size=50304, seq_len=33, global_batch=8, seed=seed)
    got = tdata.global_batch(tcfg, step, device="cpu")
    want = jdata.global_batch(jcfg, step)
    for k in ("tokens", "labels"):
        assert got[k].dtype == torch.long and got[k].device.type == "cpu"
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    shards = []
    for host in range(4):
        sh = tdata.host_shard(tcfg, step, host, 4, device="cpu")
        jsh = jdata.host_shard(jcfg, step, host, 4)
        np.testing.assert_array_equal(sh["tokens"].numpy(), np.asarray(jsh["tokens"]))
        shards.append(sh)
    for k in ("tokens", "labels"):   # host shards partition the global batch
        assert torch.equal(torch.cat([s[k] for s in shards]), got[k])
    assert torch.equal(got["tokens"][:, 1:], got["labels"][:, :-1])


# ------------------------------------------------------- loss, gradients --

def _cfgs(arch, dtype="float32"):
    return (dataclasses.replace(j_smoke(arch), dtype=dtype),
            dataclasses.replace(t_smoke(arch), dtype=dtype))


def _batch(seed=1):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, 256, size=(B, S)).astype(np.int32)
    labels = rng.integers(0, 256, size=(B, S)).astype(np.int32)
    labels[0, :5] = -1                  # masked positions
    return toks, labels


def _both(arch, dtype="float32"):
    """(reference (loss, metrics), grads) and the port's, same weights and
    batch."""
    jcfg, tcfg = _cfgs(arch, dtype)
    jparams = referee.jax_params(j_model_defs(jcfg), 0)
    toks, labels = _batch()
    jbatch = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    want = jax.jit(jax.value_and_grad(lambda p, b: j_loss_fn(p, b, jcfg),
                                      has_aux=True))(jparams, jbatch)
    tparams = params_from_numpy(_np(jparams), device="cpu")
    tbatch = {"tokens": torch.from_numpy(toks).long(),
              "labels": torch.from_numpy(labels).long()}
    got = tsteps._value_and_grad(tparams, tbatch, tcfg)
    return want, got, tparams, tbatch, tcfg


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_loss_and_gradients_match_reference(arch):
    ((jl, jm), jg), ((tl, tm), tg), tparams, _, _ = _both(arch)
    assert _rel(tl, jl) <= 1e-5, (float(tl), float(jl))
    assert _rel(tm["ce"], jm["ce"]) <= 1e-5
    assert abs(float(tm["aux"]) - float(jm["aux"])) <= 1e-5 * max(abs(float(jm["aux"])), 1.0)
    _close_per_leaf(tg, _np(jg), 1e-4)
    # the caller's tree is never marked for autograd
    assert not any(p.requires_grad for _, p in _named_leaves(tparams))


@pytest.mark.parametrize("arch", ["olmo_1b", "moonshot_v1_16b_a3b", "jamba_1_5_large_398b"])
def test_bf16_activation_loss_matches_reference(arch):
    ((jl, _), _), ((tl, _), tg), _, _, _ = _both(arch, dtype="bfloat16")
    assert _rel(tl, jl) <= 2e-2, (float(tl), float(jl))
    assert all(torch.isfinite(g).all() for _, g in _named_leaves(tg))


@pytest.mark.parametrize("arch", ["olmo_1b", "qwen3_moe_235b_a22b", "jamba_1_5_large_398b"])
@pytest.mark.parametrize("policy", ["full", "dots"])
def test_remat_gives_the_no_remat_loss_and_gradients(arch, policy):
    _, tcfg = _cfgs(arch)
    jparams = referee.jax_params(j_model_defs(_cfgs(arch)[0]), 0)
    tparams = params_from_numpy(_np(jparams), device="cpu")
    toks, labels = _batch(2)
    batch = {"tokens": torch.from_numpy(toks).long(),
             "labels": torch.from_numpy(labels).long()}
    (l0, m0), g0 = tsteps._value_and_grad(
        tparams, batch, dataclasses.replace(tcfg, remat=False))
    (l1, m1), g1 = tsteps._value_and_grad(
        tparams, batch, dataclasses.replace(tcfg, remat=True, remat_policy=policy))
    assert torch.equal(l0, l1) and torch.equal(m0["aux"], m1["aux"])
    for (n, a), (_, b) in zip(_named_leaves(g0), _named_leaves(g1)):
        assert torch.equal(a, b), n


# ----------------------------------------------------------------- AdamW --

def _opt_inputs(seed, big=False):
    rng = np.random.default_rng(seed)
    shapes = {"blocks": {"w": (3, 8, 16), "scale": (3, 8)}, "bias": (16,),
              "emb": (32, 8)}
    params = jax.tree.map(lambda s: rng.normal(size=s).astype(np.float32), shapes,
                          is_leaf=lambda s: isinstance(s, tuple))
    gscale = 50.0 if big else 0.01
    grads = [jax.tree.map(lambda p: (gscale * rng.normal(size=p.shape)).astype(np.float32),
                          params) for _ in range(3)]
    return params, grads


@pytest.mark.parametrize("clipped", [False, True], ids=["unclipped", "clipped"])
def test_adamw_three_updates_match_reference(clipped):
    params, grads = _opt_inputs(0, big=clipped)
    jcfg = jadamw.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=10)
    tcfg = tadamw.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=10)
    jp = jax.tree.map(jnp.asarray, params)
    jst = jadamw.init_opt_state(jp)
    tp = params_from_numpy(params, device="cpu")
    tst = tadamw.init_opt_state(tp)
    before = {n: x.clone() for n, x in _named_leaves(tp)}
    for g in grads:
        jp, jst, jstats = jadamw.adamw_update(jcfg, jp, jax.tree.map(jnp.asarray, g), jst)
        tp_new, tst, tstats = tadamw.adamw_update(tcfg, tp, params_from_numpy(g, "cpu"), tst)
        # functional: the parameters it was given are untouched
        assert all(torch.equal(before[n], x) for n, x in _named_leaves(tp))
        tp = tp_new
        before = {n: x.clone() for n, x in _named_leaves(tp)}
        assert _rel(tstats["grad_norm"], jstats["grad_norm"]) <= 1e-6
        assert _rel(tstats["lr"], jstats["lr"]) <= 1e-6
    if clipped:
        assert float(tstats["grad_norm"]) > tcfg.clip_norm
    assert int(tst.step) == int(jst.step) == 3 and tst.step.dtype == torch.int32
    _close_per_leaf(tp, _np(jp), 1e-6)
    _close_per_leaf(tst.m, _np(jst.m), 1e-6)
    _close_per_leaf(tst.v, _np(jst.v), 1e-6)


def test_warmup_cosine_matches_reference():
    jcfg = jadamw.AdamWConfig(lr=3e-3, warmup_steps=20, total_steps=150)
    tcfg = tadamw.AdamWConfig(lr=3e-3, warmup_steps=20, total_steps=150)
    steps = np.arange(201, dtype=np.int32)
    want = np.asarray(jadamw.warmup_cosine(jcfg, jnp.asarray(steps)))
    got = tadamw.warmup_cosine(tcfg, torch.from_numpy(steps)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    assert got[0] == 0 and got[-1] == pytest.approx(3e-4, rel=1e-6)


def test_bf16_parameters_keep_their_dtype():
    params = {"w": torch.randn(4, 8).to(torch.bfloat16), "b": torch.randn(8)}
    st = tadamw.init_opt_state(params)
    new, st, _ = tadamw.adamw_update(tadamw.AdamWConfig(), params,
                                     {"w": torch.ones(4, 8, dtype=torch.bfloat16),
                                      "b": torch.ones(8)}, st)
    assert new["w"].dtype == torch.bfloat16 and st.m["w"].dtype == torch.float32


# ----------------------------------------------------------- compression --

@pytest.mark.parametrize("shape", [(64, 32), (7, 13), (3, 5, 17), (100,)])
@pytest.mark.parametrize("p,L", [(0.5, 7), (0.25, 5)])
def test_compress_grad_bit_identical_to_eager_reference(shape, p, L):
    g = (np.random.default_rng(sum(shape)).normal(size=shape) * 1e-3).astype(np.float32)
    g.reshape(-1)[:16] = 0.0                          # an all-zero block
    want = np.asarray(jcomp.compress_grad(jnp.asarray(g), p=p, L=L))
    got = tcomp.compress_grad(torch.from_numpy(g), p=p, L=L)
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    np.testing.assert_array_equal(got.numpy(), want)


def test_compress_grad_within_one_scale_ulp_of_jitted_reference():
    g = (np.random.default_rng(5).normal(size=(96, 40)) * 1e-2).astype(np.float32)
    want = np.asarray(jax.jit(jcomp.compress_grad)(jnp.asarray(g)))
    got = tcomp.compress_grad(torch.from_numpy(g)).numpy()
    blocks = np.abs(g.reshape(-1, 16)).max(axis=1, keepdims=True) / 127.0
    ulp = np.spacing(blocks.astype(np.float32))
    # decoded values are integers |v| <= 128 times the scale
    assert (np.abs(got - want).reshape(-1, 16) <= 128 * ulp).all()


def test_error_feedback_telescopes_and_payload_ratio():
    rng = np.random.default_rng(0)
    gs = [{"w": torch.from_numpy((rng.normal(size=(32, 16)) * 1e-3).astype(np.float32)),
           "b": torch.from_numpy(rng.normal(size=(16,)).astype(np.float32))}
          for _ in range(6)]
    st = tcomp.init_ef_state(gs[0])
    jst = jcomp.init_ef_state(jax.tree.map(lambda t: jnp.asarray(t.numpy()), gs[0]))
    sum_dec = torch.zeros(32, 16)
    for g in gs:
        dec, st = tcomp.compress_tree_with_ef(g, st)
        jdec, jst = jcomp.compress_tree_with_ef(
            jax.tree.map(lambda t: jnp.asarray(t.numpy()), g), jst)
        np.testing.assert_array_equal(dec["w"].numpy(), np.asarray(jdec["w"]))
        np.testing.assert_array_equal(st.residual["w"].numpy(),
                                      np.asarray(jst.residual["w"]))
        assert torch.equal(dec["b"], g["b"]) and not st.residual["b"].any()
        sum_dec += dec["w"]
    # Σ decoded = Σ g - final residual (the bias telescopes)
    total = sum(g["w"] for g in gs)
    np.testing.assert_allclose((sum_dec + st.residual["w"]).numpy(), total.numpy(),
                               rtol=0, atol=1e-8)
    for p, q in [(0.5, 4), (0.25, 3), (1.0, 4), (0.0, 4)]:
        assert tcomp.payload_ratio(p, q) == jcomp.payload_ratio(p, q)
    assert tcomp.payload_ratio() == pytest.approx(0.6875)


# ------------------------------------------------------------ train step --

def _sys_cfgs():
    return JModelConfig(**SYS, dtype="float32"), ModelConfig(**SYS, dtype="float32")


def _mostly_close(got, want, rel, frac):
    """All but ``frac`` of all elements within ``rel`` of their leaf's
    largest |value|; returns the count outside."""
    got, want = _leaves(got), _leaves(want)
    off = sum(int((np.abs(got[k].astype(np.float64) - want[k])
                   > rel * np.abs(want[k]).max()).sum()) for k in want)
    total = sum(w.size for w in want.values())
    assert off <= frac * total, (off, total)
    return off


def _port_state(jp, jo_st, jef):
    """The reference's (params, opt state[, EF state]) as the port's, on the
    CPU: each port step below starts from the reference's state."""
    tp = params_from_numpy(_np(jp), device="cpu")
    to_st = tadamw.OptState(torch.tensor(int(jo_st.step), dtype=torch.int32),
                            params_from_numpy(_np(jo_st.m), device="cpu"),
                            params_from_numpy(_np(jo_st.v), device="cpu"))
    tef = None if jef is None else tcomp.CompressionState(
        params_from_numpy(_np(jef.residual), device="cpu"))
    return tp, to_st, tef


@pytest.mark.parametrize("compress", [False, True], ids=["plain", "compressed"])
def test_train_step_matches_jitted_reference(compress):
    """Three jitted reference steps against three port steps, from weights
    drawn by one numpy generator (``referee.numpy_params``), so the draw
    does not change with Python's hash salt.  Without
    compression the port's steps are chained, and after the third every
    parameter and moment is within 1e-4 of its leaf's largest value.  With
    it, the codec's rounding and mask choices are discontinuous: a gradient
    element the two packages compute 1e-7 apart can round to the
    neighbouring int8 code (or swap its block's pow2 choice), and the
    jitted reference's scale is one ulp off as well (``amax / 127`` as a
    reciprocal multiply).  Which elements sit that close to a code boundary
    depends on the last bits of the reference's gradients, and those vary
    with the compile history of the process that runs it (CPU XLA), so
    chained steps let a handful of flips grow into thousands of moved
    elements.  So each compressed port step starts from the reference's
    state after the step before (re-based), and what is held is one step's
    gap, which cannot compound: the metrics at 1e-4, and all but 0.1% of
    parameters, moments and the error-feedback residual at 1e-4; and the
    port's codec on the reference's own gradients is within one ulp of each
    block's scale times 128 of the reference's jitted codec (the codec is
    held bit for bit on identical inputs above)."""
    jcfg, tcfg = _sys_cfgs()
    jo = jadamw.AdamWConfig(lr=3e-3, warmup_steps=10, total_steps=120)
    to = tadamw.AdamWConfig(lr=3e-3, warmup_steps=10, total_steps=120)
    jdc = jdata.DataConfig(vocab_size=256, seq_len=64, global_batch=8, seed=3)
    tdc = tdata.DataConfig(vocab_size=256, seq_len=64, global_batch=8, seed=3)
    jp = jax.tree.map(jnp.asarray, referee.numpy_params(j_model_defs(jcfg), 0))
    jo_st = jadamw.init_opt_state(jp)
    jstep = jax.jit(j_make_train_step(jcfg, jo, grad_compression=compress))
    tstep = tsteps.make_train_step(tcfg, to, grad_compression=compress)
    jef = jcomp.init_ef_state(jp) if compress else None
    jgrad = jax.jit(jax.grad(lambda p, b: j_loss_fn(p, b, jcfg)[0]))
    jcodec = jax.jit(jcomp.compress_grad)
    tp, to_st, tef = _port_state(jp, jo_st, jef)
    for s in range(3):
        jb, tb = jdata.global_batch(jdc, s), tdata.global_batch(tdc, s, "cpu")
        if compress:
            tp, to_st, tef = _port_state(jp, jo_st, jef)
            for name, g in _named_leaves(_np(jgrad(jp, jb))):
                if g.ndim < 2:
                    continue
                got = tcomp.compress_grad(torch.tensor(g)).numpy()
                want = np.asarray(jcodec(jnp.asarray(g)))
                flat = np.pad(g.reshape(-1), (0, (-g.size) % 16))
                ulp = np.spacing(np.abs(flat.reshape(-1, 16)).max(axis=1) / 127.0)
                gap = np.abs(got - want).reshape(-1)
                lim = np.repeat(128 * ulp, 16)[:gap.size]
                assert (gap <= lim).all(), (s, name, float((gap - lim).max()))
            jp, jo_st, jef, jm = jstep(jp, jo_st, jef, jb)
            tp, to_st, tef, tm = tstep(tp, to_st, tef, tb)
        else:
            jp, jo_st, jm = jstep(jp, jo_st, jb)
            tp, to_st, tm = tstep(tp, to_st, tb)
        assert set(tm) == {"loss", "ce", "aux", "grad_norm", "lr"}
        assert all(isinstance(v, torch.Tensor) for v in tm.values())
        for k in ("loss", "ce", "grad_norm", "lr"):
            assert _rel(tm[k], jm[k]) <= 1e-4, (s, k, float(tm[k]), float(jm[k]))
        assert int(to_st.step) == int(jo_st.step) == s + 1
        if compress:
            for got, want in ((tp, jp), (to_st.m, jo_st.m), (to_st.v, jo_st.v),
                              (tef.residual, jef.residual)):
                _mostly_close(got, _np(want), 1e-4, 1e-3)
    if not compress:
        _close_per_leaf(tp, _np(jp), 1e-4)
        _close_per_leaf(to_st.m, _np(jo_st.m), 1e-4)
        _close_per_leaf(to_st.v, _np(jo_st.v), 1e-4)


REFEREE_SEEDS = (0, 1, 2)


@pytest.fixture(scope="module")
def f64_referee(tmp_path_factory):
    """The reference's step-0 gradients and three chained steps in float64,
    for each of :data:`REFEREE_SEEDS`, from one subprocess."""
    out = tmp_path_factory.mktemp("f64") / "referee.npz"
    here = Path(__file__).resolve().parent
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "OMP_NUM_THREADS": "1",
           "PYTHONPATH": os.pathsep.join([str(here.parent / "src"), str(here)])}
    subprocess.run([sys.executable, str(here / "_torch_f64_referee.py"), str(out),
                    *map(str, REFEREE_SEEDS)], check=True, env=env, timeout=600)
    with np.load(out) as f:
        return {k: f[k] for k in f.files}


@pytest.mark.parametrize("seed", REFEREE_SEEDS)
def test_train_step_f32_runs_near_the_f64_referee(seed, f64_referee):
    """Both f32 runs of the train-step test against the reference in
    float64 (the port in float64 gives the same results to 1e-13).  The
    step-0 loss of each is within 1e-6 relative of the referee and every
    gradient leaf within 2e-6 of its largest value: f32 sums in two orders,
    equally far from the truth.  After three chained AdamW steps every
    parameter and moment leaf of each run is within 5e-4 of its largest
    value.  The gap grows between the two: AdamW divides each gradient
    element by its own root mean square, so an element whose true gradient
    is ~1e-9 (an f32 rounding of its sum) moves by a share of the learning
    rate set by its rounding.  Which run lands nearer the truth at such an
    element is chance: over 16 hash-keyed draws of the reference's
    ``init_params`` the worst leaf sat 2.7e-4 from the referee for the port
    and 2.1e-4 for the reference, each the farther of the two on some
    draws; that is why the test above holds the two runs to 1e-4 on one
    fixed draw."""
    jcfg, tcfg = _sys_cfgs()
    host = referee.numpy_params(j_model_defs(jcfg), seed)
    truth = {k.split("/", 1)[1]: v for k, v in f64_referee.items()
             if k.startswith(f"s{seed}/")}

    def part(tag):
        return {k.split("/", 1)[1]: v for k, v in truth.items() if k.startswith(tag + "/")}

    jp = jax.tree.map(jnp.asarray, host)
    tp = params_from_numpy(host, device="cpu")
    jdc, tdc = jdata.DataConfig(**referee.DATA), tdata.DataConfig(**referee.DATA)
    jl, jg = jax.jit(jax.value_and_grad(lambda p, b: j_loss_fn(p, b, jcfg)[0]))(
        jp, jdata.global_batch(jdc, 0))
    (tl, _), tg = tsteps._value_and_grad(tp, tdata.global_batch(tdc, 0, "cpu"), tcfg)
    for loss in (jl, tl):
        assert _rel(loss, truth["loss"]) <= 1e-6, (float(loss), float(truth["loss"]))
    for g in (jg, tg):
        _close_per_leaf(g, part("g"), 2e-6)

    jstep = jax.jit(j_make_train_step(jcfg, jadamw.AdamWConfig(**referee.ADAMW)))
    tstep = tsteps.make_train_step(tcfg, tadamw.AdamWConfig(**referee.ADAMW))
    jst, tst = jadamw.init_opt_state(jp), tadamw.init_opt_state(tp)
    for s in range(referee.STEPS):
        jp, jst, _ = jstep(jp, jst, jdata.global_batch(jdc, s))
        tp, tst, _ = tstep(tp, tst, tdata.global_batch(tdc, s, "cpu"))
    for tag, got in (("p", (jp, tp)), ("m", (jst.m, tst.m)), ("v", (jst.v, tst.v))):
        for run in got:
            _close_per_leaf(run, part(tag), 5e-4)


def test_train_entry_point_runs_on_the_cpu(tmp_path, capsys):
    argv = ["--arch", "olmo_1b", "--smoke", "--steps", "4", "--batch", "2",
            "--seq", "32", "--device", "cpu", "--workdir", str(tmp_path),
            "--ckpt-every", "2"]
    assert ttrain.main(argv) == 0
    out = capsys.readouterr().out
    assert "step 0:" in out and "done" in out
    assert sorted(p.name for p in (tmp_path / "ckpt").iterdir()) == [
        "step_000000002", "step_000000004"]
    # a second run with more steps resumes from step 4
    assert ttrain.main(argv[:4] + ["6"] + argv[5:]) == 0
    assert "resumed from step 4" in capsys.readouterr().out


def test_train_default_workdir_follows_tmpdir(tmp_path, monkeypatch):
    """Without --workdir the checkpoints go under the system's temporary
    directory, one directory for each config."""
    import tempfile
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    argv = ["--arch", "olmo_1b", "--smoke", "--steps", "1", "--batch", "2",
            "--seq", "16", "--device", "cpu", "--ckpt-every", "1"]
    work = tmp_path / "repro_torch_train" / "olmo_1b_smoke"
    assert ttrain.workdir(ttrain.parse_args(argv)) == str(work)
    assert ttrain.main(argv) == 0
    assert [p.name for p in (work / "ckpt").iterdir()] == ["step_000000001"]


# -------------------------------------------- learning, PTQ, serving --

SYS_DATA = tdata.DataConfig(vocab_size=256, seq_len=64, global_batch=8, seed=3)
SYS_CFG = ModelConfig(**SYS)           # bf16 activations, as test_system.py


def _train(seed, compress, steps=120):
    params = init_params(model_defs(SYS_CFG), seed=seed, device="cpu",
                         dtype_override="float32")
    opt = tadamw.init_opt_state(params)
    step = tsteps.make_train_step(
        SYS_CFG, tadamw.AdamWConfig(lr=3e-3, warmup_steps=10, total_steps=steps),
        grad_compression=compress)
    ef = tcomp.init_ef_state(params) if compress else None
    losses = []
    for s in range(steps):
        batch = tdata.global_batch(SYS_DATA, s, device="cpu")
        if compress:
            params, opt, ef, m = step(params, opt, ef, batch)
        else:
            params, opt, m = step(params, opt, batch)
        losses.append(float(m["ce"]))
    return params, losses


@pytest.fixture(scope="module")
def trained():
    return _train(0, compress=False)


@torch.no_grad()
def _eval_ce(params, cfg=SYS_CFG):
    return float(np.mean([float(loss_fn(params, tdata.global_batch(SYS_DATA, 9000 + i,
                                                                     device="cpu"),
                                        cfg)[1]["ce"]) for i in range(3)]))


def test_training_reduces_loss(trained):
    _, losses = trained
    assert np.mean(losses[-10:]) < np.mean(losses[:10]) - 0.5


def test_compressed_training_reduces_loss():
    _, losses = _train(1, compress=True)
    assert np.mean(losses[-10:]) < np.mean(losses[:10]) - 0.5


def test_ptq_quality_ordering(trained):
    """tests/test_system.py's orderings on the port's trained weights; its
    "int8" arm is ``default_policy(None)`` (the default StruMConfig over the
    INT8 baseline), kept as the reference writes it."""
    params, _ = trained
    base = _eval_ce(params)
    int8 = _eval_ce(fake_quantize(params, policy=default_policy(None), device="cpu"))
    assert abs(int8 - base) < 0.05
    ce = {}
    for method, kw in [("sparsity", {}), ("dliq", dict(q=4)), ("mip2q", dict(L=7))]:
        scfg = StruMConfig(method=method, p=0.5, **kw)
        ce[method] = _eval_ce(fake_quantize(params, policy=default_policy(scfg),
                                            device="cpu"))
    assert ce["dliq"] - int8 < 0.10
    assert ce["mip2q"] - int8 < 0.10
    assert ce["sparsity"] > max(ce["dliq"], ce["mip2q"])


@torch.no_grad()
def test_compressed_serving_agrees_teacher_forced(trained):
    from repro_torch.launch.serve import serve
    params, _ = trained
    scfg = StruMConfig(method="mip2q", p=0.5, L=7)
    mcfg = dataclasses.replace(SYS_CFG, strum=scfg)
    served = build_plan(params, cfg=scfg, device="cpu").params
    prompt = tdata.global_batch(SYS_DATA, 50, device="cpu")["tokens"][:2, :24]
    toks_d, _, _ = serve(SYS_CFG, params, prompt, 8, device="cpu")
    toks_q, _, _ = serve(mcfg, served, prompt, 8, device="cpu")
    assert toks_q.shape == toks_d.shape
    seq = torch.cat([prompt, toks_d], dim=1)
    lg_d, _ = forward_train(params, {"tokens": seq}, SYS_CFG)
    lg_q, _ = forward_train(served, {"tokens": seq}, mcfg)
    n = prompt.shape[1]
    pred_d = lg_d[:, n - 1:-1, :SYS_CFG.vocab_size].argmax(-1)
    pred_q = lg_q[:, n - 1:-1, :SYS_CFG.vocab_size].argmax(-1)
    assert float((pred_d == pred_q).float().mean()) > 0.7
