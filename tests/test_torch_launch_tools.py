"""The port's launch tools against the JAX reference on the CPU: the dry-run
helpers, the input specs and the H100 dry-run.

* helpers: ``SHAPES``; ``abstract_params`` / ``tree_bytes``,
  ``abstract_opt_state``, ``batch_specs`` shape for shape (tokens and
  labels int64 where the reference's are int32); ``packed_model_defs`` leaf
  for leaf (shape, dtype, axes) for all ten full-size configs, and equal to
  ``build_plan``'s packed fields on tiny configs (an empty field floored at
  one row, as the reference's defs floor it); Eq. 1 / 2,
  ``np_to_blocks``, ``block_shape_ok``, ``dequantize_int8`` exactly.
* specs: ``input_specs`` for 10 archs x 4 shapes, ``cfg.strum`` unset and
  mip2q p = 0.5 L = 5, shape for shape and dtype for dtype (int32 -> int64
  for tokens and labels; ``cache_len`` the Python int ``seq_len``);
  ``input_shardings`` equal to the reference's partition specs on 16x16 and
  2x16x16 meshes (the reference on a ``jax.sharding.AbstractMesh``, the
  port on a stand-in object).
* dry-run on tiny configs: the extrapolated FLOPs, bytes and kernel calls
  equal a direct count at 4 periods exactly (train, prefill, decode; dense
  and packed, mip2q p = 0.5 and dliq p = 1); kernel FLOPs equal a hand count
  of 2·M·K·N over the step's packed linears; ``model_flops_total``'s formula
  against the reference's for all 40 cells; the live-bytes peak of a known
  chain; the counter runs a kernel's plain version on ``meta`` only, and
  every K1-K11 plain version takes its wrapper's arguments; the CLI records
  ``OK``, ``SKIP(full-attn)`` and ``FAIL`` and goes on.
"""
import dataclasses
import json
import math

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs.base import ARCH_IDS
from repro.configs.base import SHAPES as J_SHAPES
from repro.configs.base import get_config as j_get
from repro.core import blocking as jblocking
from repro.core import compression_ratio as j_eq1
from repro.core import compression_ratio_sparsity as j_eq2
from repro.core.policy import StruMConfig as JCfg
from repro.core.quantizers import dequantize_int8 as j_dequant_int8
from repro.launch import specs as jspecs
from repro.models import model_defs as j_model_defs
from repro.models.params import ParamDef as JDef
from repro.models.params import abstract_params as j_abstract
from repro.models.params import tree_bytes as j_tree_bytes
from repro.models.quantize import packed_model_defs as j_packed_defs
from repro.optim.adamw import abstract_opt_state as j_abstract_opt
from repro_torch import core as tcore
from repro_torch.configs.base import SHAPES, ShapeSpec, get_config, tiny_variant
from repro_torch.core import blocking
from repro_torch.core.apply import _named_leaves
from repro_torch.core.policy import StruMConfig as TCfg
from repro_torch.core.policy import default_policy
from repro_torch.core.quantizers import dequantize_int8
from repro_torch.data.pipeline import DataConfig, batch_specs
from repro_torch.engine import build_plan
from repro_torch.launch import dryrun, specs
from repro_torch.models import model_defs
from repro_torch.models.params import ParamDef, abstract_params, init_params, tree_bytes
from repro_torch.models.quantize import packed_model_defs
from repro_torch.models.sharding import PartitionSpec
from repro_torch.optim.adamw import abstract_opt_state

torch.set_num_threads(1)  # xdist runs several workers side by side: one intra-op thread each

MIP2Q = dict(method="mip2q", p=0.5, L=5)
DLIQ_P1 = dict(method="dliq", p=1.0, q=4)
MESHES = ({"data": 16, "model": 16}, {"pod": 2, "data": 16, "model": 16})


class StandIn:
    """A mesh-like object: axis names and sizes, no devices."""

    def __init__(self, shape):
        self.shape, self.axis_names = dict(shape), tuple(shape)


def _cfgs(arch, strum):
    j, t = j_get(arch), get_config(arch)
    if strum:
        j, t = dataclasses.replace(j, strum=JCfg(**MIP2Q)), \
            dataclasses.replace(t, strum=TCfg(**MIP2Q))
    return j, t


def _jleaves(tree, is_leaf=None):
    out = []
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)[0]:
        out.append(("/".join(str(getattr(k, "key", getattr(k, "idx", getattr(k, "name", k))))
                             for k in path), leaf))
    return out


def _dtype(x) -> str:
    return str(x.dtype).replace("torch.", "")


# ------------------------------------------------------------- helpers --

def test_shapes_are_the_references():
    assert list(SHAPES) == list(J_SHAPES)
    for name, s in SHAPES.items():
        assert dataclasses.astuple(s) == dataclasses.astuple(J_SHAPES[name])


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_abstract_params_and_tree_bytes(arch):
    jcfg, tcfg = _cfgs(arch, strum=False)
    jdefs, tdefs = j_model_defs(jcfg), model_defs(tcfg)
    assert tree_bytes(tdefs) == j_tree_bytes(jdefs)
    for over in (None, "bfloat16"):
        j = _jleaves(j_abstract(jdefs, dtype_override=over))
        t = list(_named_leaves(abstract_params(tdefs, dtype_override=over)))
        assert [n for n, _ in t] == [n for n, _ in j]
        for (_, a), (_, b) in zip(j, t):
            assert b.device.type == "meta"
            assert tuple(b.shape) == tuple(a.shape) and _dtype(b) == str(a.dtype)
    opt = abstract_opt_state(abstract_params(tdefs))
    jopt = j_abstract_opt(j_abstract(jdefs))
    assert opt.step.device.type == "meta" and opt.step.dtype == torch.int32
    assert str(jopt.step.dtype) == "int32"
    for jm, tm in ((jopt.m, opt.m), (jopt.v, opt.v)):
        for (_, a), (_, b) in zip(_jleaves(jm), _named_leaves(tm)):
            assert tuple(b.shape) == tuple(a.shape) and b.dtype == torch.float32
    assert opt.m is not opt.v


def test_batch_specs_map_int32_tokens_to_int64():
    from repro.data.pipeline import DataConfig as JData
    from repro.data.pipeline import batch_specs as j_batch_specs
    for modality in ("text", "audio"):
        j = j_batch_specs(JData(vocab_size=100, seq_len=12, global_batch=3), 64, modality)
        t = batch_specs(DataConfig(vocab_size=100, seq_len=12, global_batch=3), 64,
                        modality)
        assert set(t) == set(j)
        for k, a in j.items():
            assert tuple(t[k].shape) == tuple(a.shape) and t[k].device.type == "meta"
            want = torch.long if str(a.dtype) == "int32" else torch.bfloat16
            assert t[k].dtype == want


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_packed_model_defs_match_the_reference(arch):
    jcfg, tcfg = _cfgs(arch, strum=True)
    j = _jleaves(j_packed_defs(jcfg), is_leaf=lambda x: isinstance(x, JDef))
    t = list(_named_leaves(packed_model_defs(tcfg)))
    assert [n for n, _ in t] == [n for n, _ in j]
    for (name, a), (_, b) in zip(j, t):
        assert isinstance(b, ParamDef)
        assert (b.shape, b.axes, b.dtype) == (tuple(a.shape), tuple(a.axes), a.dtype), name
    assert tree_bytes(packed_model_defs(tcfg)) == j_tree_bytes(j_packed_defs(jcfg))


@pytest.mark.parametrize("arch", ("qwen2_7b", "moonshot_v1_16b_a3b", "jamba_1_5_large_398b"))
@pytest.mark.parametrize("strum", [MIP2Q, dict(method="dliq", p=0.25, q=4),
                                   dict(method="sparsity", p=0.25),
                                   dict(method="dliq", p=1.0, q=4)])
def test_packed_model_defs_match_build_plan(arch, strum):
    """Each packed leaf's defs are the field shapes and dtypes that
    ``build_plan`` packs on the same config, expert stacks included; an
    empty field (sparsity's lo, hi at p = 1) keeps the reference's one-row
    floor in the defs (the row the kernels are handed) where the plan
    stores 0 rows."""
    cfg = dataclasses.replace(tiny_variant(get_config(arch)), strum=TCfg(**strum))
    plan = build_plan(init_params(model_defs(cfg), device="cpu"), cfg=cfg.strum,
                      device="cpu")
    defs = dict(_named_leaves(packed_model_defs(cfg)))
    packed = {n.rsplit("/", 1)[0] for n in defs if n.endswith("/mask")}
    assert packed == set(plan.entries)
    floored = 0
    for name, e in plan.entries.items():
        for f in ("mask", "hi", "lo", "scale"):
            d, got = defs[f"{name}/{f}"], tuple(e.leaf[f].shape)
            if got[-2] == 0:
                got, floored = got[:-2] + (1,) + got[-1:], floored + 1
            assert d.shape == got, (name, f)
            assert d.dtype == _dtype(e.leaf[f]), (name, f)
    assert bool(floored) == (strum["method"] == "sparsity" or strum["p"] == 1.0)


def test_core_helpers_are_the_references():
    for p in np.linspace(0, 1, 9):
        assert tcore.compression_ratio_sparsity(p) == j_eq2(p)
        for q in range(1, 9):
            assert tcore.compression_ratio(p, q) == j_eq1(p, q)
    assert TCfg(**MIP2Q).compression_ratio == tcore.compression_ratio(0.5, 4)
    for w in range(0, 257):
        assert blocking.block_shape_ok(w) == jblocking.block_shape_ok(w)
    rng = np.random.default_rng(0)
    for k, w in ((64, 16), (70, 16), (5, 8), (33, 32)):
        x = rng.normal(size=(k, 7)).astype(np.float32)
        np.testing.assert_array_equal(blocking.np_to_blocks(x, w),
                                      jblocking.np_to_blocks(x, w))
    codes = rng.integers(-127, 128, size=(32, 9)).astype(np.int8)
    scale = rng.random((1, 9)).astype(np.float32)
    got = dequantize_int8(torch.from_numpy(codes), torch.from_numpy(scale))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(j_dequant_int8(codes, scale)))


# --------------------------------------------------------------- specs --

@pytest.mark.parametrize("strum", [False, True])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_specs_match_the_reference(arch, strum):
    jcfg, tcfg = _cfgs(arch, strum)
    for name, shape in SHAPES.items():
        j = jspecs.input_specs(jcfg, J_SHAPES[name])
        t = specs.input_specs(tcfg, shape)
        assert len(t) == len(j)
        if shape.kind == "decode":
            assert t[-1] == shape.seq_len and isinstance(t[-1], int)
            assert str(j[-1].dtype) == "int32" and j[-1].shape == ()
            j, t = j[:-1], t[:-1]
        jl, tl = _jleaves(j), list(_named_leaves(t))
        assert len(jl) == len(tl), (arch, name)
        for (jn, a), (tn, b) in zip(jl, tl):
            assert b.device.type == "meta"
            assert tuple(b.shape) == tuple(a.shape), (arch, name, jn, tn)
            tokens = jn.rsplit("/", 1)[-1] in ("tokens", "labels") or \
                (shape.kind == "decode" and jn == "1" and tcfg.modality == "text")
            want = "int64" if tokens else str(a.dtype)
            assert _dtype(b) == want, (arch, name, jn)


def _norm(spec) -> tuple:
    out = []
    for e in spec:
        e = None if e in (None, ()) else (e[0] if isinstance(e, tuple) and len(e) == 1
                                          else e)
        out.append(e)
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def _port_specs(tree) -> list:
    out = []

    def walk(x):
        if isinstance(x, PartitionSpec):
            out.append(x)
        elif isinstance(x, dict):
            for k in sorted(x):
                walk(x[k])
        elif isinstance(x, tuple):
            for v in x:
                walk(v)
    walk(tree)
    return out


@pytest.mark.parametrize("mesh", MESHES, ids=("16x16", "2x16x16"))
@pytest.mark.parametrize("strum", [False, True])
def test_input_shardings_match_the_reference(mesh, strum):
    am = AbstractMesh(tuple(mesh.values()), tuple(mesh))
    n = 0
    for arch in ARCH_IDS:
        jcfg, tcfg = _cfgs(arch, strum)
        for name, shape in SHAPES.items():
            j = [s.spec for s in jax.tree.leaves(jspecs.input_shardings(
                jcfg, J_SHAPES[name], am))]
            t = _port_specs(specs.input_shardings(tcfg, shape, StandIn(mesh)))
            assert len(t) == len(j), (arch, name)
            for a, b in zip(j, t):
                assert _norm(b) == _norm(a), (arch, name, a, b)
                n += 1
            assert specs.batch_axes(StandIn(mesh), shape.global_batch) == \
                jspecs.batch_axes(am, shape.global_batch)
    assert n > 1000


def test_padded_cache_len_is_the_references():
    for s in (1, 511, 512, 2047, 2048, 32768, 524288):
        assert specs.padded_cache_len(s) == jspecs.padded_cache_len(s)


# ------------------------------------------------------------- dry-run --

TINY = ShapeSpec("tiny", 32, 2, "train")


def _shape(kind):
    return dataclasses.replace(TINY, kind=kind)


@pytest.mark.parametrize("kind", ("train", "prefill", "decode"))
@pytest.mark.parametrize("arch,strum", [("qwen2_7b", None), ("qwen2_7b", MIP2Q),
                                        ("qwen2_7b", DLIQ_P1),
                                        ("moonshot_v1_16b_a3b", MIP2Q)])
def test_extrapolation_equals_a_direct_count(arch, strum, kind):
    """Four periods counted directly and extrapolated from 1, 2 (and, for a
    train step, 3) periods: FLOPs, bytes and kernel calls equal exactly."""
    cfg = tiny_variant(get_config(arch))
    cfg = dataclasses.replace(cfg, n_layers=4 * dryrun.period(cfg),
                              strum=strum and TCfg(**strum))
    shape = _shape(kind)
    got = dryrun.extrapolated_costs(cfg, shape)
    want = dryrun.count_step(cfg, shape)
    for k in ("flops", "flops_by_dtype", "bytes", "aten_bytes", "kernel_bytes",
              "kernels"):
        assert got[k] == want[k], k
    if strum and kind != "train":
        k2d = "cuda:maskfree" if strum["p"] == 1.0 else "cuda:onehot"
        assert want["kernels"][k2d] > 0
        assert bool(want["kernels"].get("cuda:grouped")) == bool(cfg.n_experts)
    else:
        assert want["kernels"] == {}


@pytest.mark.parametrize("kind", ("prefill", "decode"))
@pytest.mark.parametrize("arch", ("qwen2_7b", "moonshot_v1_16b_a3b"))
def test_kernel_flops_are_two_mkn_over_the_linears(arch, kind):
    """2·M·K·N over every packed linear (M the step's tokens) and, for an
    expert stack, 2·C·K·N per expert at its capacity C."""
    from repro_torch.models.moe import _capacity
    cfg = dataclasses.replace(tiny_variant(get_config(arch), n_layers=3),
                              strum=TCfg(**MIP2Q))
    shape = _shape(kind)
    m = shape.global_batch * (shape.seq_len if kind == "prefill" else 1)
    policy = default_policy(cfg.strum)
    want, calls = 0, {}
    for n, d in _named_leaves(model_defs(cfg)):
        if "/moe/" in n and n.rsplit("/", 1)[-1] in ("wi", "wg", "wo"):
            want += 2 * _capacity(m, cfg) * math.prod(d.shape)
            calls["cuda:grouped"] = calls.get("cuda:grouped", 0) + d.shape[0]
        elif n.endswith("/w") and policy.resolve(n, d.shape) is not None:
            want += 2 * m * math.prod(d.shape)
            calls["cuda:onehot"] = calls.get("cuda:onehot", 0) + d.shape[0]
    got = dryrun.count_step(cfg, shape)
    assert got["kernels"] == calls and got["kernel_flops"] == want


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_model_flops_formula_is_the_references(arch):
    jcfg, tcfg = _cfgs(arch, strum=False)
    for name, shape in SHAPES.items():
        tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode" else 1)
        want = (6.0 if shape.kind == "train" else 2.0) * jcfg.active_param_count() \
            * tokens
        assert dryrun.model_flops(tcfg, shape) == want


def test_counter_tracks_the_live_bytes_peak_and_arguments():
    x = torch.empty((64, 32), dtype=torch.float32, device="meta")
    counter = dryrun.Counter()
    assert counter.hold(x) == 64 * 32 * 4
    with counter:
        a = x + 1             # live: a
        b = a * 2             # live: a, b (the peak)
        del a
        c = b.sum()           # live: b, c
        out = c.exp()
    assert counter.peak == 2 * 64 * 32 * 4
    n = 64 * 32 * 4
    assert counter.bytes == 2 * (2 * n) + (n + 4) + (4 + 4)   # add, mul, sum, exp
    assert counter.flops == {} and out.shape == ()


def fake_kernel(x, scale, *, w):
    return x * w


def fake_kernel_plain(x, scale, *, w):
    return x - w


def test_counter_runs_the_plain_version_on_meta_only():
    """On ``meta`` the counter runs a kernel's plain version; on any other
    device the wrapper itself (the kernel on the card), and a call that
    mixes ``meta`` with another device is refused."""
    counter = dryrun.Counter()
    x, scale = torch.ones(2, 3), torch.ones(1, 3)
    with counter:
        y = counter.kernel("cuda:dense", fake_kernel, x, scale, w=4)
        ym = counter.kernel("cuda:dense", fake_kernel, x.to("meta"),
                            scale.to("meta"), w=4)
        with pytest.raises(ValueError, match="meta tensors mixed"):
            counter.kernel("cuda:dense", fake_kernel, x.to("meta"), scale, w=4)
    assert torch.equal(y, torch.full((2, 3), 4.0)) and ym.device.type == "meta"
    assert counter.kernels == {"cuda:dense": 2}
    assert counter.kernel_flops == {"torch.float32": 2 * 2 * (2 * 3 * 3)}


_WRAPPERS = [("strum_matmul", n) for n in (
    "strum_matmul_onehot", "strum_matmul_maskfree", "strum_matmul_dense",
    "strum_matmul_grouped_onehot", "strum_matmul_grouped_maskfree",
    "strum_matmul_grouped_dense", "strum_matmul_histream", "strum_matmul_maskfree_p")] + \
    [("strum_attention", "strum_paged_attention"),
     ("strum_attention", "strum_paged_attention_maskfree"),
     ("strum_decode", "strum_page_decode")]


@pytest.mark.parametrize("module,name", _WRAPPERS)
def test_plain_versions_take_their_wrappers_arguments(module, name):
    """The counter calls ``<wrapper>_plain`` with the arguments the wrapper
    hands to the hooks slot: every parameter of K1-K11's wrappers binds."""
    import importlib
    import inspect
    mod = importlib.import_module(f"repro_torch.kernels.{module}")
    params = inspect.signature(getattr(mod, name)).parameters.values()
    pos = [None for p in params if p.kind is p.POSITIONAL_OR_KEYWORD]
    kw = {p.name: None for p in params if p.kind is p.KEYWORD_ONLY}
    inspect.signature(getattr(mod, name + "_plain")).bind(*pos, **kw)


def test_count_step_memory_record():
    cfg = tiny_variant(get_config("olmo_1b"))
    shape = _shape("decode")
    rec = dryrun.count_step(cfg, shape)
    inputs = specs.input_specs(cfg, shape)
    args = sum(t.numel() * t.element_size() for _, t in _named_leaves(inputs[:3]))
    assert rec["memory"]["argument_bytes"] == args
    # the decode step writes its caches in place and returns them: aliased
    caches = sum(t.numel() * t.element_size() for _, t in _named_leaves(inputs[2]))
    assert rec["memory"]["alias_bytes"] == caches
    assert rec["memory"]["output_bytes"] == caches + 2 * cfg.padded_vocab * 4


def test_roofline_terms_pick_the_largest():
    r = dryrun.roofline_terms(1.0, 3.35e12 * 2, 0)
    assert r["bottleneck"] == "memory" and r["memory_s"] == pytest.approx(2.0)
    assert dryrun.roofline_terms(5.0, 0, 450e9)["bottleneck"] == "compute"


def test_cli_records_every_cell_and_goes_on(tmp_path, monkeypatch):
    out = tmp_path / "dry.json"
    rc = dryrun.main(["--arch", "mamba2_780m", "--shape", "long_500k", "--out", str(out)])
    assert rc == 0
    rc = dryrun.main(["--arch", "olmo_1b", "--shape", "long_500k", "--out", str(out)])
    recs = json.loads(out.read_text())
    assert rc == 0 and [r["status"] for r in recs] == ["OK", "SKIP(full-attn)"]
    ok = recs[0]
    assert ok["mesh"] == "1x1" and ok["n_devices"] == 1 and ok["kind"] == "decode"
    assert ok["roofline"]["collective_s"] == 0 and ok["link_bytes_per_dev"] == 0
    assert set(ok["memory"]) == {"argument_bytes", "output_bytes", "temp_bytes",
                                 "alias_bytes"}
    assert ok["useful_flops_ratio"] == pytest.approx(
        ok["model_flops_total"] / ok["flops_per_dev"])

    def boom(*a, **k):
        raise RuntimeError("no rule for aten.foo")
    monkeypatch.setattr(dryrun, "lower_cell", boom)
    rc = dryrun.main(["--arch", "qwen2_7b", "--shape", "decode_32k", "--out", str(out)])
    recs = json.loads(out.read_text())
    assert rc == 1 and recs[-1]["status"] == "FAIL: RuntimeError: no rule for aten.foo"
    assert "traceback" in recs[-1]
    # cached cells are not counted again
    assert dryrun.main(["--arch", "mamba2_780m", "--shape", "long_500k",
                        "--out", str(out)]) == 1
    assert len(json.loads(out.read_text())) == 3
