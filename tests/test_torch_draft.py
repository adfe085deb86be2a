"""The port's draft lowerings (K9, K10 plain versions), the ``draft:*``
registry partition and draft plans against the JAX reference.

Inputs are made with numpy and go through both sides: the reference's
Pallas draft kernels in interpret mode (``repro.kernels.ops.
strum_matmul_draft(..., interpret=True)``, as its own tests run them) and
the port's ``kernels.ops.strum_matmul_draft`` on CPU tensors, which runs
each kernel's plain version.  Tolerance 1e-5 x max|ref| + 1e-6: both sum
the same f32 products, the reference with the column scale applied before
the sum and the port after it.  ``draft_dequant_packed`` and the plans'
byte counts must be exact.
"""
import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import engine as jengine
from repro import telemetry as jtelemetry
from repro.analysis.registry_audit import default_grid
from repro.configs.base import get_smoke_config as j_smoke
from repro.core import packing as jpacking
from repro.core.policy import LayerPolicy as JPolicy
from repro.core.policy import StruMConfig as JCfg
from repro.engine.draft import draft_dequant_packed as j_draft_dequant_packed
from repro.kernels import ops as jops
from repro.models import model_defs as j_model_defs
from repro_torch import engine, telemetry
from repro_torch.core.apply import pack_array
from repro_torch.core.policy import DEFAULT_EXCLUDE
from repro_torch.core.policy import LayerPolicy as TPolicy
from repro_torch.core.policy import StruMConfig as TCfg
from repro_torch.kernels import ops
from repro_torch.kernels import strum_matmul as K
from repro_torch.models.params import params_from_numpy

import _torch_f64_referee as referee

torch.set_num_threads(1)  # xdist runs several workers side by side: one intra-op thread each

FIELDS = ("mask", "hi", "lo", "scale")
MODES = ("histream", "maskfree_p")
CODECS = [dict(method="dliq", q=4), dict(method="dliq", q=3),
          dict(method="mip2q", L=5), dict(method="mip2q", L=3),
          dict(method="sparsity")]
# method x q/L x w x p; M cycles through 1, 4, 13 and K % w != 0 throughout
GRID = [dict(c, w=w, p=p) for c in CODECS for w in (8, 16, 32)
        for p in (0.25, 0.5, 0.75)]
MS = (1, 4, 13)


def _case(i):
    cfg = GRID[i]
    rng = np.random.default_rng(100 + i)
    k, n, m = 3 * cfg["w"] + 5, 24, MS[i % len(MS)]
    x = rng.normal(size=(m, k)).astype(np.float32)
    packed = pack_array(torch.from_numpy(rng.normal(size=(k, n)).astype(np.float32)),
                        TCfg(**cfg))
    return x, packed


def _to_jax(packed):
    return jpacking.PackedStruM(*packed[:6], **{f: jnp.asarray(getattr(packed, f).numpy())
                                                for f in FIELDS})


@pytest.fixture(scope="module")
def reference_drafts():
    """Every grid case and mode through the reference's draft kernels in
    interpret mode, in one jit (one compile)."""
    inputs = [_case(i) for i in range(len(GRID))]

    def run(xs, fields):
        return [[jops.strum_matmul_draft(x, jpacking.PackedStruM(
            *p[:6], **dict(zip(FIELDS, f))), mode=mode, interpret=True)
            for mode in MODES] for (_, p), x, f in zip(inputs, xs, fields)]
    xs = [jnp.asarray(x) for x, _ in inputs]
    fields = [tuple(jnp.asarray(getattr(p, f).numpy()) for f in FIELDS)
              for _, p in inputs]
    return [[np.asarray(y) for y in ys] for ys in jax.jit(run)(xs, fields)]


@pytest.mark.parametrize("i", range(len(GRID)), ids=[
    f"{c['method']}-q{c.get('q', c.get('L', ''))}-w{c['w']}-p{c['p']}-M{MS[i % 3]}"
    for i, c in enumerate(GRID)])
def test_draft_kernels_match_reference(reference_drafts, i):
    x, packed = _case(i)
    counts = dict(K.launch_counts)
    for mode, want in zip(MODES, reference_drafts[i]):
        got = ops.strum_matmul_draft(torch.from_numpy(x), packed, mode=mode).numpy()
        assert got.shape == want.shape
        tol = 1e-5 * np.abs(want).max() + 1e-6
        assert np.abs(got - want).max() <= tol, (mode, GRID[i])
    assert K.launch_counts == counts            # the CPU path launches nothing


@pytest.mark.parametrize("mode", MODES)
def test_kernel_wrappers_route_to_plain_versions_on_cpu(mode):
    """The K9/K10 wrappers on CPU tensors are their plain versions, and the
    plain versions read only the fields of their mode (lo is not even an
    argument)."""
    x, packed = _case(4)
    xt = torch.from_numpy(x)
    kw = dict(w=packed.w, n_low=packed.n_low)
    if mode == "histream":
        got = K.strum_matmul_histream(xt, packed.mask, packed.hi, packed.scale, **kw)
        want = K.strum_matmul_histream_plain(xt, packed.mask, packed.hi, packed.scale,
                                             **kw)
    else:
        got = K.strum_matmul_maskfree_p(xt, packed.hi, packed.scale, **kw)
        want = K.strum_matmul_maskfree_p_plain(xt, packed.hi, packed.scale, **kw)
    assert torch.equal(got, want)
    dense = engine.draft_dequant_packed(packed, mode)
    np.testing.assert_allclose(got.numpy(), (xt @ dense).numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("i", [0, 7, 13, 22, 31, 44])
@pytest.mark.parametrize("mode", MODES)
def test_draft_dequant_packed_matches_reference_exactly(i, mode):
    _, packed = _case(i)
    want = np.asarray(j_draft_dequant_packed(_to_jax(packed), mode))
    got = engine.draft_dequant_packed(packed, mode).numpy()
    assert got.dtype == want.dtype and np.array_equal(got, want)


def _error(fn):
    try:
        fn()
    except ValueError as e:
        return str(e)
    raise AssertionError("no ValueError")


@pytest.mark.parametrize("cfg,mode,k_in", [
    (dict(method="dliq", p=1.0, q=4), "histream", 40),     # n_low == w
    (dict(method="dliq", p=0.5, q=4), "bogus", 40),         # unknown mode
    (dict(method="dliq", w=12, p=0.5, q=4), "histream", 40),  # w % 8 != 0
    (dict(method="mip2q", p=0.5, L=5), "maskfree_p", 39),   # K mismatch
])
def test_draft_guard_errors_match_reference(cfg, mode, k_in):
    rng = np.random.default_rng(5)
    packed = pack_array(torch.from_numpy(rng.normal(size=(40, 8)).astype(np.float32)),
                        TCfg(**cfg))
    x = rng.normal(size=(2, k_in)).astype(np.float32)
    want = _error(lambda: jops.strum_matmul_draft(jnp.asarray(x), _to_jax(packed),
                                                  mode=mode, interpret=True))
    got = _error(lambda: ops.strum_matmul_draft(torch.from_numpy(x), packed, mode=mode))
    assert got == want
    if mode in MODES and packed.n_low >= packed.w:
        assert _error(lambda: engine.draft_dequant_packed(packed, mode)) == \
            _error(lambda: j_draft_dequant_packed(_to_jax(packed), mode))
    if mode not in MODES:
        assert _error(lambda: ops.draft_field_set(mode)) == \
            _error(lambda: jops.draft_field_set(mode))
        assert _error(lambda: engine.DraftPolicy(mode=mode)) == \
            _error(lambda: jengine.DraftPolicy(mode=mode))


# --------------------------------------------------------------- registry --

TWIN = {"draft:histream": "draft:histream", "draft:maskfree_p": "draft:maskfree_p",
        "draft:xla_histream": "draft:torch_histream",
        "draft:xla_maskfree_p": "draft:torch_maskfree_p"}


def _select(select, cfg, info, **kw):
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        try:
            name = select(cfg, info, **kw).name
        except LookupError:
            name = None
    return name, bool(caught)


def test_draft_partition_twins_reference_across_audit_grid():
    """Every point of the audit grid x draft mode x backend (and stacked
    leaves): the port selects the twin of the reference's draft variant,
    finds none exactly where the reference finds none, and warns where it
    warns; a full-fidelity selection never lands on a draft variant."""
    n = 0
    for jcfg in default_grid():
        tcfg = TCfg(method=jcfg.method, w=jcfg.w, p=jcfg.p, q=jcfg.q, L=jcfg.L)
        for mode in MODES:
            for lead in ((), (4,)):
                jinfo = jengine.LeafInfo(k_dim=256, n_out=512, lead=lead, draft=mode)
                tinfo = engine.LeafInfo(k_dim=256, n_out=512, lead=lead, draft=mode)
                for jb, tb in (("pallas", "cuda"), ("xla", "torch")):
                    jname, jwarn = _select(jengine.select_variant, jcfg, jinfo, backend=jb)
                    tname, twarn = _select(engine.select_variant, tcfg, tinfo, backend=tb)
                    assert tname == (jname and TWIN[jname]), (jcfg, mode, jb)
                    assert twarn == jwarn
                    n += 1
        name, _ = _select(engine.select_variant, tcfg,
                          engine.LeafInfo(k_dim=256, n_out=512), backend="cuda")
        assert not engine.get_variant(name).draft
    assert n > 200


# ------------------------------------------------------------ draft plans --

FULL = TCfg(method="mip2q", p=0.5, L=5)


def _policies(cls, cfg_cls):
    """A uniform policy, and one mixing leaves with and without a draft
    lowering: w = 12 (no histream), p = 1 and p = 0 (no high or no low
    values to skip)."""
    return [cls(default=cfg_cls(method="mip2q", p=0.5, L=5)),
            cls(default=cfg_cls(method="dliq", p=0.5, q=4), exclude=DEFAULT_EXCLUDE,
                overrides=((r"/mlp/wi/", cfg_cls(method="dliq", w=12, p=0.5, q=4)),
                           (r"/mlp/wg/", cfg_cls(method="dliq", p=1.0, q=4)),
                           (r"/attn/wk/", cfg_cls(method="mip2q", p=0.0, L=5)),
                           (r"/attn/wo/", cfg_cls(method="sparsity", w=8, p=0.5))))]


DRAFT_POLICIES = [dict(mode="histream"), dict(mode="maskfree_p"),
                  dict(mode="histream", overrides=(("/wq/", "maskfree_p"),
                                                   ("/mlp/wo/", "full")))]


@pytest.fixture(scope="module", params=["qwen2_7b", "moonshot_v1_16b_a3b"])
def arch_params(request):
    jcfg = dataclasses.replace(j_smoke(request.param), dtype="float32")
    jparams = referee.jax_params(j_model_defs(jcfg), 0)
    return request.param, jparams, params_from_numpy(jax.tree.map(np.asarray, jparams),
                                                     device="cpu")


def _leaf(tree, name):
    for k in name.split("/"):
        tree = tree[k]
    return tree


@pytest.mark.parametrize("pi", range(2))
@pytest.mark.parametrize("di", range(len(DRAFT_POLICIES)))
def test_draft_plan_matches_reference(arch_params, pi, di):
    """Per-leaf mode map, variants (family swapped) and byte counts equal
    the reference's; every drafted payload tensor is the target's."""
    arch, jparams, tparams = arch_params
    jpol = _policies(JPolicy, JCfg)[pi]
    tpol = _policies(TPolicy, TCfg)[pi]
    jplan = jengine.build_plan(jparams, policy=jpol)
    plan = engine.build_plan(tparams, policy=tpol, device="cpu")
    jdraft = jengine.build_draft_plan(jplan, jengine.DraftPolicy(**DRAFT_POLICIES[di]))
    draft = engine.build_draft_plan(plan, engine.DraftPolicy(**DRAFT_POLICIES[di]))

    assert draft.meta["draft"] == jdraft.meta["draft"]
    assert draft.meta["draft_policy"] == jdraft.meta["draft_policy"]
    want = {n: TWIN.get(v, v.replace("xla:", "torch:")) for n, v in
            jdraft.variants().items()}
    assert draft.variants() == want
    modes = draft.meta["draft"]
    assert any(modes.values())
    if arch == "moonshot_v1_16b_a3b":       # expert stacks keep full fidelity
        assert all(not m for n, m in modes.items() if "/moe/" in n)
    assert engine.draft_plan_bytes(draft) == jengine.draft_plan_bytes(jdraft)
    assert plan.meta == {} and plan.variants() != draft.variants()

    for name, mode in modes.items():
        got, target = _leaf(draft.params, name), _leaf(plan.params, name)
        for f in FIELDS:
            assert got[f] is target[f]
            assert got[f].untyped_storage().data_ptr() == \
                target[f].untyped_storage().data_ptr()
        assert (got["spec"] is target["spec"]) == (not mode)
        if mode:
            assert got["spec"].variant == f"draft:torch_{mode}"
            assert draft[name].leaf is got
            np.testing.assert_array_equal(
                engine.draft_dequant_leaf(got, mode).numpy(),
                np.asarray(jengine.draft_dequant_leaf(_leaf(jdraft.params, name), mode)))


def test_draft_plan_bytes_ratio_olmo_default():
    """Every OLMo-style linear at mip2q w=16 p=0.5: mask 2 + hi 8 + lo 4
    bytes per 16 weights, so the ratios are exactly 10/14 and 8/14."""
    rng = np.random.default_rng(0)
    params = {"blocks": {"pos0": {"attn": {"wq": {"w": torch.from_numpy(
        rng.normal(size=(2, 64, 32)).astype(np.float32))}}}}}
    plan = engine.build_plan(params, cfg=FULL, device="cpu")
    for mode, ratio in (("histream", 10 / 14), ("maskfree_p", 8 / 14)):
        b = engine.draft_plan_bytes(engine.build_draft_plan(plan, engine.DraftPolicy(mode)))
        assert b["ratio"] == ratio and b["full_bytes"] == 2 * 4 * 14 * 32


def test_per_call_backend_stays_in_the_draft_partition(arch_params):
    """A per-call ``backend=`` on a draft leaf re-selects inside the draft
    partition (never full fidelity), with the reference's numbers and
    counters."""
    _, jparams, tparams = arch_params
    name = "blocks/pos0/attn/wq/w"
    plan = engine.build_plan(tparams, cfg=FULL, device="cpu")
    draft = engine.build_draft_plan(plan, engine.DraftPolicy("histream"))
    jdraft = jengine.build_draft_plan(jengine.build_plan(jparams, cfg=JCfg(
        method="mip2q", p=0.5, L=5)), jengine.DraftPolicy("histream"))
    leaf = {k: v[0] if isinstance(v, torch.Tensor) else v
            for k, v in _leaf(draft.params, name).items()}
    jleaf = {k: v[0] if k in FIELDS else v for k, v in _leaf(jdraft.params, name).items()}
    x = np.random.default_rng(1).normal(size=(3, leaf["spec"].k_dim)).astype(np.float32)
    with telemetry.recording() as rec:
        got = engine.dispatch(leaf, torch.from_numpy(x), backend="torch")
    with jtelemetry.recording() as jrec:
        want = jengine.dispatch(jleaf, jnp.asarray(x), backend="xla")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    assert rec.counters("dispatch/variant/") == {"draft:torch_histream": 1}
    assert jrec.counters("dispatch/variant/") == {"draft:xla_histream": 1}
    for key in ("spec/draft_packed_bytes", "dispatch/packed_bytes"):
        assert rec.counter(key) == jrec.counter(key) == \
            leaf["mask"].numel() + leaf["hi"].numel()
    # the card's draft variant, never cuda:onehot, and it will not run on CPU
    with pytest.raises(ValueError, match="draft:histream runs on CUDA tensors"):
        engine.dispatch(leaf, torch.from_numpy(x), backend="cuda")
    # the spec alone (no per-call backend) is authoritative
    full = engine.dispatch(leaf, torch.from_numpy(x))
    assert torch.equal(full, got)
