"""The port's numerics interpreter (``repro_torch.analysis.numerics``) and its
consumers against the reference's (``repro.analysis.numerics``) on the CPU.

The reference runs with a two-entry shim, applied in a fixture: jax 0.9
names the call primitive ``jit`` where ``_CALL_PRIMS`` knows ``pjit``, and
emits ``split``, which has no rule in ``_RULES`` (``slice``'s pass-through
rule is the right one).  Without it every downstream value of the smoke
model goes to TOP and the reference is no oracle.  Weights are drawn once
in the test process from a numpy seed and both sides get the same arrays.

* (a) rule parity: one parametrised test over tiny functions written in
  both frameworks, covering every rule family, the rms-norm, softmax and
  flash idioms, a matmul kernel call (K1's plain route through
  ``kernels.hooks``) and the ``torch`` family's payload decode:
  ``interval``, ``per_tag``, ``total`` and ``per_tag_err2`` within rtol
  1e-9;
* (b) the reference's soundness grid on the qwen2_7b smoke model in f32
  at tokens (2, 48): the port's bound dominates its own measured error,
  with no unsupported op and no finding, and agrees with the reference's
  within rtol 1e-3 (the measured gap is ~1e-7, f32 constant tables);
* (c) the single-leaf bound, err2 ordering, ``check_error_budget`` and
  ``output_gains`` linearity; (d) ``output_error_profile``; (e)
  ``search_schedule(proxy="output_error", fn=)``; (f)
  ``search_draft_schedule(fn=)``; (g) ``verify_numerics``; (h) the CLI's
  exit codes; and the float64 leaf statistics against numpy's.
"""
import dataclasses
import math
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from jax import lax

from repro import autotune as jat
from repro import engine as jengine
from repro.analysis import numerics as JN
from repro.configs.base import get_smoke_config as j_smoke
from repro.core.policy import StruMConfig as JCfg
from repro.models import model_defs as j_model_defs
from repro.models.attention import _chunked_causal as j_chunked
from repro.models.layers import rms_norm as j_rms_norm
from repro.models.params import ParamDef, _fan_in
from repro.models.transformer import forward_train as j_forward
from repro_torch import autotune as tat
from repro_torch import engine as tengine
from repro_torch.analysis import numerics as TN
from repro_torch.configs.base import get_smoke_config as t_smoke
from repro_torch.core.policy import StruMConfig as TCfg
from repro_torch.kernels.strum_matmul import strum_matmul_onehot
from repro_torch.models.attention import _chunked_causal as t_chunked
from repro_torch.models.layers import rms_norm as t_rms_norm
from repro_torch.models.params import params_from_numpy
from repro_torch.models.quantize import _pack_leaf
from repro_torch.models.transformer import forward_train as t_forward

torch.set_num_threads(1)  # xdist runs several workers side by side: one intra-op thread each

ARCH = "qwen2_7b"
RULE_RTOL = 1e-9
MODEL_RTOL = 1e-3


@pytest.fixture(scope="module", autouse=True)
def shim():
    """The reference's interpreter, made to read jax 0.9's jaxprs."""
    mp = pytest.MonkeyPatch()
    mp.setitem(JN._CALL_PRIMS, "jit", "jaxpr")
    mp.setitem(JN._RULES, "split", JN._rule_pass)
    yield
    mp.undo()


def _close(got, want, rtol, what):
    if math.isinf(want) or math.isinf(got):
        assert got == want, (what, got, want)
    else:
        assert math.isclose(got, want, rel_tol=rtol, abs_tol=1e-300), (what, got, want)


def _same_result(got, want, rtol):
    for i in range(2):
        _close(got.interval[i], want.interval[i], rtol, f"interval[{i}]")
    _close(got.total, want.total, rtol, "total")
    for field in ("per_tag", "per_tag_err2"):
        g, w = getattr(got, field), getattr(want, field)
        assert g.keys() == w.keys(), (field, g.keys(), w.keys())
        for t in w:
            _close(g[t], w[t], rtol, f"{field}[{t}]")


# -------------------------------------------------------- (a) rule parity --

def _inputs():
    rng = np.random.default_rng(11)
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    p = {"w": f(4, 8), "v": f(8, 6), "s": np.ones(8, np.float32),
         "idx": np.array([3, 0, 2, 2, 1], np.int32),
         "wq": f(8, 64) / 3, "wk": f(8, 32) / 3, "wv": f(8, 32) / 3}
    return p, {"x": f(4, 8), "fx": f(1, 48, 8)}


SEED = {"w": JN.LeafStats(lo=0.0, hi=0.0, err=0.01, err2=1e-4, ms=0.0)}
T_SEED = {"w": TN.LeafStats(lo=0.0, hi=0.0, err=0.01, err2=1e-4, ms=0.0)}


def _softmax_j(z):
    m = jnp.max(z, axis=-1, keepdims=True)
    e = jnp.exp(z - m)
    return e / jnp.sum(e, axis=-1, keepdims=True)


def _log_softmax_j(z):
    s = z - jnp.max(z, axis=-1, keepdims=True)
    return s - jnp.log(jnp.sum(jnp.exp(s), axis=-1, keepdims=True))


def _flash_j(p, x):
    fx = x["fx"]
    q = (fx @ p["wq"]).reshape(1, 48, 4, 16)
    k = (fx @ p["wk"]).reshape(1, 48, 2, 16)
    v = (fx @ p["wv"]).reshape(1, 48, 2, 16)
    return j_chunked(q, k, v, j_smoke(ARCH).attn_chunk)


def _flash_t(p, x):
    fx = x["fx"]
    q = (fx @ p["wq"]).reshape(1, 48, 4, 16)
    k = (fx @ p["wk"]).reshape(1, 48, 2, 16)
    v = (fx @ p["wv"]).reshape(1, 48, 2, 16)
    return t_chunked(q, k, v, t_smoke(ARCH).attn_chunk)


# name -> (reference fn, port fn); both take (params, inputs), ``w`` seeded
CASES = {
    "add": (lambda p, x: p["w"] + x["x"], lambda p, x: p["w"] + x["x"]),
    "sub": (lambda p, x: x["x"] - p["w"], lambda p, x: x["x"] - p["w"]),
    "mul": (lambda p, x: x["x"] * p["w"], lambda p, x: x["x"] * p["w"]),
    "div": (lambda p, x: x["x"] / (p["w"] * p["w"] + 1.0),
            lambda p, x: x["x"] / (p["w"] * p["w"] + 1.0)),
    "dot": (lambda p, x: (x["x"] * p["w"]) @ p["v"],
            lambda p, x: (x["x"] * p["w"]) @ p["v"]),
    "einsum": (lambda p, x: jnp.einsum("bij,jk->bik", (x["x"] * p["w"]).reshape(2, 2, 8),
                                       p["v"]),
               lambda p, x: torch.einsum("bij,jk->bik", (x["x"] * p["w"]).reshape(2, 2, 8),
                                         p["v"])),
    "reduce_sum": (lambda p, x: jnp.sum(x["x"] * p["w"], axis=-1),
                   lambda p, x: torch.sum(x["x"] * p["w"], dim=-1)),
    "mean": (lambda p, x: jnp.mean(x["x"] * p["w"], axis=-1, keepdims=True),
             lambda p, x: torch.mean(x["x"] * p["w"], dim=-1, keepdim=True)),
    "reduce_max": (lambda p, x: jnp.max(x["x"] * p["w"], axis=0),
                   lambda p, x: torch.amax(x["x"] * p["w"], dim=0)),
    "reduce_min": (lambda p, x: jnp.min(x["x"] * p["w"], axis=1),
                   lambda p, x: torch.amin(x["x"] * p["w"], dim=1)),
    "cumsum": (lambda p, x: jnp.cumsum(x["x"] * p["w"], axis=1),
               lambda p, x: torch.cumsum(x["x"] * p["w"], dim=1)),
    "exp": (lambda p, x: jnp.exp(x["x"] * p["w"] * 0.1),
            lambda p, x: torch.exp(x["x"] * p["w"] * 0.1)),
    "maximum": (lambda p, x: jnp.maximum(x["x"], p["w"]),
                lambda p, x: torch.maximum(x["x"], p["w"])),
    "minimum": (lambda p, x: jnp.minimum(x["x"] * p["w"], 0.5),
                lambda p, x: torch.clamp(x["x"] * p["w"], max=0.5)),
    "select": (lambda p, x: jnp.where(x["x"] * p["w"] > 0, x["x"] * p["w"], -p["w"]),
               lambda p, x: torch.where(x["x"] * p["w"] > 0, x["x"] * p["w"], -p["w"])),
    "compare": (lambda p, x: (x["x"] * p["w"] > 0.5).astype(jnp.float32) + p["w"],
                lambda p, x: (x["x"] * p["w"] > 0.5).to(torch.float32) + p["w"]),
    "reshape": (lambda p, x: (x["x"] * p["w"]).T.reshape(-1) * 2.0,
                lambda p, x: (x["x"] * p["w"]).T.reshape(-1) * 2.0),
    "gather": (lambda p, x: p["w"][p["idx"]] * 2.0,
               lambda p, x: p["w"][p["idx"]] * 2.0),
    "concatenate": (lambda p, x: jnp.concatenate([x["x"] * p["w"], p["w"]], axis=0),
                    lambda p, x: torch.cat([x["x"] * p["w"], p["w"]], dim=0)),
    "pad": (lambda p, x: jnp.pad(x["x"] * p["w"], ((0, 1), (0, 0))),
            lambda p, x: F.pad(x["x"] * p["w"], (0, 0, 0, 1))),
    "update_slice": (lambda p, x: lax.dynamic_update_slice(x["x"] * p["w"],
                                                           p["w"][:, :2] * 3.0, (0, 3)),
                     lambda p, x: (x["x"] * p["w"]).slice_scatter(p["w"][:, :2] * 3.0,
                                                                  dim=1, start=3, end=5)),
    "iota": (lambda p, x: x["x"] * p["w"] + jnp.arange(8),
             lambda p, x: x["x"] * p["w"] + torch.arange(8)),
    "square": (lambda p, x: jnp.square(x["x"] * p["w"]),
               lambda p, x: torch.square(x["x"] * p["w"])),
    "integer_pow": (lambda p, x: (x["x"] * p["w"]) ** 3, lambda p, x: (x["x"] * p["w"]) ** 3),
    "pow": (lambda p, x: jnp.power(x["x"] * p["w"], 3.0),
            lambda p, x: torch.pow(x["x"] * p["w"], 3.0)),
    "rsqrt": (lambda p, x: lax.rsqrt(x["x"] * x["x"] + p["w"] * p["w"] + 1.0),
              lambda p, x: torch.rsqrt(x["x"] * x["x"] + p["w"] * p["w"] + 1.0)),
    "sqrt": (lambda p, x: jnp.sqrt(p["w"] * p["w"] + 1.0),
             lambda p, x: torch.sqrt(p["w"] * p["w"] + 1.0)),
    "log": (lambda p, x: jnp.log(p["w"] * p["w"] + 1.0),
            lambda p, x: torch.log(p["w"] * p["w"] + 1.0)),
    "logistic": (lambda p, x: jax.nn.sigmoid(x["x"] * p["w"]),
                 lambda p, x: torch.sigmoid(x["x"] * p["w"])),
    "tanh": (lambda p, x: jnp.tanh(x["x"] * p["w"]), lambda p, x: torch.tanh(x["x"] * p["w"])),
    "trig": (lambda p, x: jnp.sin(x["x"] * p["w"]) + jnp.cos(p["w"]),
             lambda p, x: torch.sin(x["x"] * p["w"]) + torch.cos(p["w"])),
    "erf": (lambda p, x: lax.erf(x["x"] * p["w"]), lambda p, x: torch.erf(x["x"] * p["w"])),
    "abs": (lambda p, x: jnp.abs(x["x"] * p["w"]), lambda p, x: torch.abs(x["x"] * p["w"])),
    "neg": (lambda p, x: -(x["x"] * p["w"]), lambda p, x: -(x["x"] * p["w"])),
    "sign": (lambda p, x: jnp.sign(x["x"] * p["w"]), lambda p, x: torch.sign(x["x"] * p["w"])),
    "round": (lambda p, x: jnp.floor(x["x"] * p["w"]) + jnp.round(p["w"]),
              lambda p, x: torch.floor(x["x"] * p["w"]) + torch.round(p["w"])),
    "clamp": (lambda p, x: lax.clamp(-1.0, x["x"] * p["w"], 1.0),
              lambda p, x: torch.clamp(x["x"] * p["w"], -1.0, 1.0)),
    "bool": (lambda p, x: jnp.logical_and(x["x"] * p["w"] > 0, p["w"] > 0).astype(jnp.float32),
             lambda p, x: torch.logical_and(x["x"] * p["w"] > 0, p["w"] > 0).to(torch.float32)),
    "int_bitwise": (lambda p, x: ((x["x"] * p["w"] * 10).astype(jnp.int32) ^ 3).astype(
                        jnp.float32),
                    lambda p, x: ((x["x"] * p["w"] * 10).to(torch.int32) ^ 3).to(torch.float32)),
    "relu": (lambda p, x: jax.nn.relu(x["x"] * p["w"]), lambda p, x: F.relu(x["x"] * p["w"])),
    "softplus": (lambda p, x: jax.nn.softplus(x["x"] * p["w"]),
                 lambda p, x: F.softplus(x["x"] * p["w"])),
    "tril": (lambda p, x: jnp.tril(x["x"] * p["w"], -1), lambda p, x: torch.tril(x["x"] * p["w"], -1)),
    "silu": (lambda p, x: jax.nn.silu(x["x"] * p["w"]), lambda p, x: F.silu(x["x"] * p["w"])),
    "gelu": (lambda p, x: jax.nn.gelu(x["x"] * p["w"]),
             lambda p, x: F.gelu(x["x"] * p["w"], approximate="tanh")),
    "softmax": (lambda p, x: _softmax_j(x["x"] * p["w"]),
                lambda p, x: torch.softmax(x["x"] * p["w"], dim=-1)),
    "log_softmax": (lambda p, x: _log_softmax_j(x["x"] * p["w"]),
                    lambda p, x: torch.log_softmax(x["x"] * p["w"], dim=-1)),
    "rms_norm": (lambda p, x: j_rms_norm(x["x"] * p["w"], p["s"]),
                 lambda p, x: t_rms_norm(x["x"] * p["w"], p["s"])),
    "flash": (_flash_j, _flash_t),
}
SEEDED = {"flash": "wq"}


@pytest.mark.parametrize("name", sorted(CASES))
def test_rule_parity(name):
    host_p, host_x = _inputs()
    jfn, tfn = CASES[name]
    tag = SEEDED.get(name, "w")
    jseed = {tag: SEED["w"]}
    tseed = {tag: T_SEED["w"]}
    want, wrep = JN.analyze(jfn, jax.tree.map(jnp.asarray, host_p),
                            jax.tree.map(jnp.asarray, host_x), seeds=jseed)
    tp = {k: torch.from_numpy(v.copy()) for k, v in host_p.items()}
    tp["idx"] = tp["idx"].long()
    got, grep = TN.analyze(tfn, tp, {k: torch.from_numpy(v.copy()) for k, v in host_x.items()},
                           seeds=tseed)
    assert got.unsupported == want.unsupported, (got.unsupported, want.unsupported)
    assert [f.rule for f in grep.findings] == [f.rule for f in wrep.findings]
    assert got.per_tag, "the seed reached no output"
    _same_result(got, want, RULE_RTOL)
    if name == "flash":   # the port proves l >= 1 on every chain the loop unrolls
        assert got.counts.get("flash_match", 0) == 3 and not got.counts.get("flash_miss")
    if name == "rms_norm":
        assert got.counts == {"rms_match": 1}


def test_split_parts_track_no_const():
    """An exact input through ``jnp.split``: the reference's split has
    several results and tracks no const of them, so its parts read as the
    whole input; the port's ``chunk`` views must too (with a const per part
    the port would bound every product of them tighter)."""
    host_p, host_x = _inputs()
    seed = dict(lo=0.0, hi=0.0, err=0.0, err2=1.0, ms=0.0)

    def jfn(p, x):
        a, b = jnp.split(x["x"] * p["w"], 2, axis=-1)
        return a * b + a.reshape(-1)[:16].reshape(4, 4)

    def tfn(p, x):
        a, b = (x["x"] * p["w"]).chunk(2, dim=-1)
        return a * b + a.reshape(-1)[:16].reshape(4, 4)
    want, _ = JN.analyze(jfn, jax.tree.map(jnp.asarray, host_p),
                         jax.tree.map(jnp.asarray, host_x), seeds={"w": JN.LeafStats(**seed)})
    got, _ = TN.analyze(tfn, {k: torch.from_numpy(v.copy()) for k, v in host_p.items()},
                        {k: torch.from_numpy(v.copy()) for k, v in host_x.items()},
                        seeds={"w": TN.LeafStats(**seed)})
    _same_result(got, want, RULE_RTOL)


def _payload_case():
    """A packed leaf, its stats, and x, for the two matmul routes."""
    cfg = TCfg(method="mip2q", w=16, p=0.5, L=5)
    rng = np.random.default_rng(5)
    w = rng.normal(size=(64, 48)).astype(np.float32)
    leaf = {k: v.numpy() for k, v in _pack_leaf(torch.from_numpy(w), cfg).items()}
    x = rng.normal(size=(4, 64)).astype(np.float32)
    stats = dict(lo=-2.5, hi=2.75, err=0.02, err2=3e-5, ms=0.9)
    return cfg, leaf, x, stats


@pytest.mark.parametrize("route", ["k1_hook", "torch_decode"])
def test_rule_parity_payload_matmul(route):
    """A payload reaching a matmul: through K1's wrapper (one dot, the
    payload materialized to its stats) or decoded by the ``torch`` family
    outside any wrapper (payload-pure decode ops, materialized at the
    matmul), against the reference's ``xla`` decode."""
    cfg, leaf, x, stats = _payload_case()
    jcfg = JCfg(method=cfg.method, w=cfg.w, p=cfg.p, L=cfg.L)
    want, _ = JN.analyze(lambda p, xx: jengine.dispatch(p["q"], xx, strum=jcfg, backend="xla"),
                         {"q": jax.tree.map(jnp.asarray, leaf)}, jnp.asarray(x),
                         stats={"q": JN.LeafStats(**stats)})
    tleaf = {k: torch.from_numpy(v.copy()) for k, v in leaf.items()}
    if route == "k1_hook":
        def fn(p, xx):
            q = p["q"]
            return strum_matmul_onehot(xx, q["mask"], q["hi"], q["lo"], q["scale"],
                                       w=cfg.w, n_low=cfg.n_low, q=cfg.q, method=cfg.method)
    else:
        def fn(p, xx):
            return tengine.dispatch(p["q"], xx, strum=cfg, backend="torch")
    got, rep = TN.analyze(fn, {"q": tleaf}, torch.from_numpy(x),
                          stats={"q": TN.LeafStats(**stats)})
    assert not got.unsupported and not rep.findings
    if route == "k1_hook":
        assert got.counts == {"kernel:cuda:onehot": 1}
    _same_result(got, want, RULE_RTOL)


def test_data_dependent_ops_go_to_top():
    """Eager runs follow one branch: a ``topk`` or an ``.item()`` of a
    non-exact value is TOP with a finding; of an exact one, a constant."""
    x = torch.arange(8.0)

    def fn(p, xx):
        vals, idx = torch.topk(p["w"].reshape(-1), 2)
        return vals.sum() + xx[torch.argmax(xx)]

    res, rep = TN.analyze(fn, {"w": torch.ones(2, 4)}, x, seeds=T_SEED)
    assert res.per_tag["w"] == res.total and res.unsupported == ("topk",)
    assert [f.rule for f in rep.findings] == ["numerics/unsupported-op"]
    exact, rep = TN.analyze(fn, {"w": torch.ones(2, 4)}, x)
    assert not exact.unsupported and not rep.findings and exact.interval == (9.0, 9.0)
    res, rep = TN.analyze(lambda p, xx: xx * float(p["w"].sum()), {"w": torch.ones(2, 4)}, x,
                          seeds=T_SEED)
    assert res.per_tag == {"w": math.inf} and "_local_scalar_dense" in res.unsupported


# ------------------------------------------------------- (b) the smoke model --

def _numpy_params(defs, seed: int) -> dict:
    """A ParamDef tree filled from one numpy generator, in sorted-key order
    (the reference's init scales, none of its hash-keyed PRNG)."""
    rng = np.random.default_rng(seed)

    def fill(d):
        if isinstance(d, ParamDef):
            if d.init == "zeros":
                return np.zeros(d.shape, np.float32)
            if d.init == "ones":
                return np.ones(d.shape, np.float32)
            std = d.scale / np.sqrt(_fan_in(d.shape)) if d.init == "normal" else d.scale
            return (rng.normal(size=d.shape) * std).astype(np.float32)
        return {k: fill(d[k]) for k in sorted(d)}
    return fill(defs)


@pytest.fixture(scope="module")
def model():
    jcfg = dataclasses.replace(j_smoke(ARCH), dtype="float32")
    tcfg = dataclasses.replace(t_smoke(ARCH), dtype="float32")
    host = _numpy_params(j_model_defs(jcfg), seed=0)
    toks = np.random.default_rng(3).integers(0, jcfg.vocab_size, (2, 48)).astype(np.int32)
    return SimpleNamespace(
        jp=jax.tree.map(jnp.asarray, host), tp=params_from_numpy(host, device="cpu"),
        jtoks=jnp.asarray(toks), ttoks=torch.from_numpy(toks).long(),
        jfn=lambda p, t: j_forward(p, {"tokens": t}, jcfg)[0],
        tfn=lambda p, t: t_forward(p, {"tokens": t}, tcfg)[0])


@pytest.fixture(scope="module")
def analyzed(model):
    """``key -> (port plan, port result, port report, reference result,
    reference plan)``, each config analyzed once on both sides."""
    cache = {}

    def run(kw: dict):
        key = tuple(sorted(kw.items()))
        if key not in cache:
            jplan = jengine.build_plan(model.jp, cfg=JCfg(**kw), backend="xla", pack=True)
            want, _ = JN.analyze(model.jfn, jplan.params, model.jtoks,
                                 stats=JN.leaf_stats_from_plan(jplan, model.jp))
            tplan = tengine.build_plan(model.tp, cfg=TCfg(**kw), pack=True, device="cpu")
            got, rep = TN.analyze(model.tfn, tplan.params, model.ttoks,
                                  stats=TN.leaf_stats_from_plan(tplan, model.tp))
            cache[key] = (tplan, got, rep, want, jplan)
        return cache[key]
    return run


GRID = [dict(method="dliq", w=4, p=1.0, q=4), dict(method="dliq", w=8, p=0.0, q=4),
        dict(method="dliq", w=8, p=0.5, q=4), dict(method="mip2q", w=4, p=0.0, L=3),
        dict(method="mip2q", w=4, p=1.0, L=3), dict(method="mip2q", w=8, p=0.5, L=3)]


@pytest.mark.parametrize("kw", GRID, ids=[f"{c['method']}_w{c['w']}_p{c['p']}" for c in GRID])
def test_static_bound_dominates_measured_and_matches_reference(model, analyzed, kw):
    plan, got, rep, want, _ = analyzed(kw)
    assert rep.ok and not rep.findings, rep.render()
    assert not got.unsupported and not want.unsupported
    assert np.isfinite(got.interval[0]) and np.isfinite(got.interval[1])
    assert np.isfinite(got.total)
    measured = TN.measured_error(model.tfn, (model.tp, model.ttoks),
                                 (plan.params, model.ttoks))
    assert got.total >= measured, f"UNSOUND: static {got.total} < measured {measured}"
    assert set(got.per_tag) == {n for n, e in plan.entries.items() if e.leaf is not None}
    _close(got.total_err2, want.total_err2, MODEL_RTOL, "total_err2")
    _same_result(got, want, MODEL_RTOL)
    assert got.counts.get("flash_match") == 6 and not got.counts.get("flash_miss")
    assert got.counts.get("rms_match") == 5 and not got.counts.get("rms_miss")


# ------------------------------------------------ (c) bounds and estimates --

def test_per_layer_bound_single_leaf_schedule(model):
    from repro_torch.autotune.schedule import StruMSchedule

    scfg = TCfg(method="dliq", w=8, p=0.5, q=4)
    full = tengine.build_plan(model.tp, cfg=scfg, pack=True, device="cpu")
    name = sorted(n for n, e in full.entries.items() if e.leaf is not None)[0]
    plan = tengine.build_plan(model.tp, schedule=StruMSchedule(assignments={name: scfg}),
                              pack=True, device="cpu")
    res, rep = TN.analyze(model.tfn, plan.params, model.ttoks,
                          stats=TN.leaf_stats_from_plan(plan, model.tp))
    assert rep.ok, rep.render()
    assert set(res.per_tag) == {name}
    measured = TN.measured_error(model.tfn, (model.tp, model.ttoks),
                                 (plan.params, model.ttoks))
    assert res.per_tag[name] >= measured
    assert res.total == pytest.approx(res.per_tag[name])


def test_err2_tracks_method_ordering_and_budget(analyzed):
    mild, harsh = (analyzed(kw)[1] for kw in (dict(method="dliq", w=8, p=0.25, q=4),
                                             dict(method="dliq", w=8, p=1.0, q=2)))
    assert 0.0 < mild.total_err2 < harsh.total_err2
    res = analyzed(dict(method="mip2q", w=8, p=0.5, L=3))[1]
    ok = TN.check_error_budget(res, {"total": res.total * 2, "per_layer": res.total * 2})
    assert ok.ok and not ok.findings
    bad = TN.check_error_budget(res, {"total": res.total * 0.5})
    assert [(f.rule, f.severity) for f in bad.findings] == [("numerics/budget-exceeded",
                                                              "error")]
    tag, bound = max(res.per_tag.items(), key=lambda kv: kv[1])
    bad = TN.check_error_budget(res, {"per_layer": {tag: bound * 0.5}}, location="grid")
    assert [f.rule for f in bad.findings] == ["numerics/budget-exceeded"]
    assert tag in bad.findings[0].location


def test_output_gains_linearity(model):
    plan = tengine.build_plan(model.tp, cfg=TCfg(method="dliq", w=8, p=0.5, q=4),
                              pack=True, device="cpu")
    names = sorted(n for n, e in plan.entries.items() if e.leaf is not None)[:2]
    gains = TN.output_gains(model.tfn, model.tp, model.ttoks, names=tuple(names))
    assert all(g > 0 for g in gains.values()), gains
    eps = 1e-12

    def seeded(*pairs):
        seeds = {n: TN.LeafStats(0.0, 0.0, err=0.0, err2=e, ms=0.0) for n, e in pairs}
        return TN.analyze(model.tfn, model.tp, model.ttoks, seeds=seeds)[0]
    g1 = seeded((names[0], eps)).per_tag_err2[names[0]]
    assert g1 > 0
    assert seeded((names[0], 4 * eps)).per_tag_err2[names[0]] == pytest.approx(4 * g1, rel=1e-6)
    both = seeded((names[0], eps), (names[1], eps))
    assert both.per_tag_err2[names[0]] == pytest.approx(g1, rel=1e-6)
    assert set(both.per_tag_err2) == set(names)


# -------------------------------------------------------- (d)-(f) consumers --

SMALL_GRID = [dict(method="dliq", p=0.5, q=4), dict(method="mip2q", p=0.5, L=5),
              dict(method="dliq", p=0.75, q=4), dict(method="sparsity", p=0.5)]


@pytest.fixture(scope="module")
def base_profile(model):
    """The reference's weight-SQNR rows, handed to both sides."""
    return jat.profile_tree(model.jp, [JCfg(**c) for c in SMALL_GRID], use_cache=False)


def test_output_error_profile_rows_match_reference(model, base_profile):
    want = jat.output_error_profile(model.jp, model.jfn, model.jtoks,
                                    grid=[JCfg(**c) for c in SMALL_GRID],
                                    profile=base_profile)
    got = tat.output_error_profile(model.tp, model.tfn, model.ttoks,
                                   grid=[TCfg(**c) for c in SMALL_GRID],
                                   profile=base_profile)
    assert got.keys() == want.keys() and got
    for name, row in got.items():
        assert row["gain"] > 0, name
        np.testing.assert_allclose(row["gain"], want[name]["gain"], rtol=MODEL_RTOL,
                                   err_msg=name)
        assert set(row["output_err2"]) == set(row["sqnr_db"])
        for key, sq in row["sqnr_db"].items():
            assert row["output_err2"][key] == pytest.approx(
                row["gain"] * row["ms"] * 10.0 ** (-sq / 10.0), rel=1e-6)


def test_output_error_search_matches_reference(model, base_profile):
    want = jat.search_schedule(model.jp, jat.Budget(target_ratio=0.875),
                               grid=[JCfg(**c) for c in SMALL_GRID], profile=base_profile,
                               proxy="output_error", fn=model.jfn, fn_args=(model.jtoks,))
    got = tat.search_schedule(model.tp, tat.Budget(target_ratio=0.875),
                              grid=[TCfg(**c) for c in SMALL_GRID], profile=base_profile,
                              proxy="output_error", fn=model.tfn, fn_args=(model.ttoks,))
    assert got.meta["proxy"] == want.meta["proxy"] == "output_error"
    assert {n: tat.config_key(c) for n, c in got.assignments.items()} == \
        {n: jat.config_key(c) for n, c in want.assignments.items()}


def test_draft_search_from_a_forward_matches_reference(model, analyzed):
    """Gains from ``output_gains`` over the packed plan (the reference seeds
    the entry names, which no payload field's path matches, so every gain
    is 0 on both sides and every policy predicts alpha = 1)."""
    tplan, _, _, _, jplan = analyzed(dict(method="dliq", w=8, p=0.5, q=4))
    want = jat.search_draft_schedule(jplan, ks=(1, 2, 3), fn=model.jfn,
                                     fn_args=(model.jtoks,))
    got = tat.search_draft_schedule(tplan, ks=(1, 2, 3), fn=model.tfn,
                                    fn_args=(model.ttoks,))
    assert got["best"]["k"] == want["best"]["k"]
    assert got["best"]["policy"].mode == want["best"]["policy"].mode
    for a, b in zip(got["rows"], want["rows"]):
        assert (a["policy"], a["k"]) == (b["policy"], b["k"])
        np.testing.assert_allclose([a["alpha_pred"], a["speedup_pred"]],
                                   [b["alpha_pred"], b["speedup_pred"]], rtol=1e-6)


# --------------------------------------------------- (g), (h): pass and CLI --

def test_verify_numerics_is_clean():
    from repro_torch.analysis.suite import PASSES, verify_numerics

    report = verify_numerics()
    assert report.ok and not report.findings, report.render()
    assert PASSES == ("dataflow", "registry", "pallas", "recompile", "numerics", "draft")


def test_cli_numerics_exit_codes(monkeypatch, capsys):
    from repro_torch.analysis import Report
    from repro_torch.analysis import __main__ as cli

    assert cli.main(["--passes", "numerics", "--device", "cpu"]) == 0
    assert "across numerics on cpu" in capsys.readouterr().out
    dirty = Report()
    dirty.add("error", "numerics/unsound-bound", "x", "bound < measured")
    monkeypatch.setattr("repro_torch.analysis.suite.run_all",
                        lambda **kw: (dirty, None))
    assert cli.main(["--passes", "numerics", "--device", "cpu"]) == 1
    assert "numerics/unsound-bound" in capsys.readouterr().out
    assert cli.main(["--passes", "numerics,warp-drive", "--device", "cpu"]) == 2
    assert "warp-drive" in capsys.readouterr().err


def test_leaf_stats_match_numpy(model):
    """Float64 on the leaves' device, a layer at a time: the hull exactly,
    the mean squares within rtol 1e-12 of numpy's float64."""
    from repro_torch.core.apply import _named_leaves

    plan = tengine.build_plan(model.tp, cfg=TCfg(method="mip2q", w=8, p=0.5, L=3),
                              pack=True, device="cpu")
    named = dict(_named_leaves(model.tp))
    stats = TN.leaf_stats_from_plan(plan, model.tp)
    for name, entry in plan.entries.items():
        w = named[name].numpy().astype(np.float64)
        wq = entry.dequantized().numpy().astype(np.float64)
        d = wq - w
        s = stats[name]
        assert s.lo == min(w.min(), wq.min(), 0.0) and s.hi == max(w.max(), wq.max(), 0.0)
        assert s.err == np.max(np.abs(d))
        np.testing.assert_allclose([s.err2, s.ms], [np.mean(d * d), np.mean(w * w)],
                                   rtol=1e-12, err_msg=name)
