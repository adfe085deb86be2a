"""The port's grouped packed matmul (K6-K8's path) against the JAX reference.

The reference's grouped Pallas kernels run in interpret mode
(``repro.engine.dispatch_grouped(..., backend="interpret")``); the port runs
``ops.strum_grouped_matmul``, whose wrappers take the plain PyTorch version
of K6, K7 or K8 for CPU tensors, and the ``torch:dequant`` fallback through
``engine.dispatch_grouped(backend="torch")``.  Both sides get the same
seeded numpy weights and activations, and the packed stacks themselves are
held byte-identical to the reference's ``_pack_leaf``.

Tolerances: grouped outputs rtol 1e-4, atol 1e-4 (the reference test's,
f32 sums in another order and the scale applied after the sum instead of
before it); dequantized stacks exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import engine as jengine
from repro.autotune.schedule import StruMSchedule
from repro.configs.base import get_smoke_config as j_smoke
from repro.core.policy import StruMConfig as JCfg
from repro.models.moe import moe_apply as j_moe_apply
from repro.models.moe import moe_def as j_moe_def
from repro.models.quantize import _pack_leaf as j_pack_leaf
from repro_torch import engine
from repro_torch.configs.base import get_smoke_config as t_smoke
from repro_torch.core.packing import PackedStruM
from repro_torch.core.policy import DEFAULT_EXCLUDE, LayerPolicy
from repro_torch.core.policy import StruMConfig as TCfg
from repro_torch.kernels import ops
from repro_torch.models.moe import moe_apply
from repro_torch.models.params import params_from_numpy
from repro_torch.models.quantize import _pack_leaf

import _torch_f64_referee as referee

torch.set_num_threads(1)  # xdist runs several workers side by side: one intra-op thread each

TOL = dict(rtol=1e-4, atol=1e-4)
FIELDS = ("mask", "hi", "lo", "scale")
VARIANT = {"cuda:grouped": "onehot", "cuda:grouped_maskfree": "maskfree",
           "cuda:grouped_dense": "dense"}

GRID = [  # the reference test's method x w x q/L grid over the three lowerings
    ("mip2q", 16, 0.5, dict(L=5)),       # grouped (K6)
    ("mip2q", 8, 0.75, dict(L=3)),
    ("dliq", 16, 0.5, dict(q=4)),
    ("dliq", 8, 0.5, dict(q=2)),
    ("sparsity", 16, 0.5, dict()),
    ("sparsity", 16, 1.0, dict()),       # all-zero blocks, mask-only decode
    ("dliq", 16, 1.0, dict(q=4)),        # grouped_maskfree (K7)
    ("mip2q", 16, 1.0, dict(L=5)),
    ("dliq", 16, 0.0, dict(q=4)),        # grouped_dense (K8, n_low = 0)
    ("dliq", 12, 0.0, dict(q=4)),        # grouped_dense, w % 8 != 0
]


def _cfgs(method, w, p, kw):
    return JCfg(method=method, w=w, p=p, **kw), TCfg(method=method, w=w, p=p, **kw)


def _stack(shape, jcfg, tcfg, seed):
    """Both sides' packed stacks of the same seeded weights; asserts the
    payloads are byte-identical and returns (reference leaf, port leaf)."""
    wt = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    jleaf = dict(j_pack_leaf(jnp.asarray(wt), jcfg))
    tleaf = dict(_pack_leaf(torch.from_numpy(wt), tcfg))
    for f in FIELDS:
        a, b = np.asarray(jleaf[f]), tleaf[f].numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, f
        assert a.tobytes() == b.tobytes(), f
    jleaf["cfg"], tleaf["cfg"] = jcfg, tcfg
    return jleaf, tleaf


def _packed(tleaf, tcfg, k):
    return PackedStruM(method=tcfg.method, w=tcfg.w, n_low=tcfg.n_low, q=tcfg.q,
                       L=tcfg.L, k_dim=k, **{f: tleaf[f] for f in FIELDS})


def _kernel_variant(tcfg, lead):
    """The grouped lowering the cuda family selects for this config."""
    v = engine.select_variant(tcfg, engine.LeafInfo(k_dim=1, n_out=1, lead=lead),
                              backend="cuda")
    assert v.grouped, v.name
    return VARIANT[v.name]


@pytest.mark.parametrize("k", [48, 40])  # 40: K % w != 0 for w in {16, 12}
@pytest.mark.parametrize("method,w,p,kw", GRID)
def test_grouped_parity(method, w, p, kw, k):
    jcfg, tcfg = _cfgs(method, w, p, kw)
    jleaf, tleaf = _stack((3, k, 96), jcfg, tcfg, seed=k + w)
    x = np.random.default_rng(1).normal(size=(3, 5, k)).astype(np.float32)
    want = np.asarray(jengine.dispatch_grouped(jleaf, jnp.asarray(x),
                                               backend="interpret"))
    xt = torch.from_numpy(x)
    got = ops.strum_grouped_matmul(xt, _packed(tleaf, tcfg, k),
                                   variant=_kernel_variant(tcfg, (3,)))
    np.testing.assert_allclose(got.numpy(), want, **TOL, err_msg="plain K6-K8")
    got = engine.dispatch_grouped(tleaf, xt, backend="torch")
    np.testing.assert_allclose(got.numpy(), want, **TOL, err_msg="torch:dequant")


def test_grouped_multi_lead_dims():
    """Scan-grouped expert stacks (two lead dims) flatten into one group axis."""
    jcfg, tcfg = _cfgs("mip2q", 16, 0.5, dict(L=5))
    jleaf, tleaf = _stack((2, 3, 32, 96), jcfg, tcfg, seed=3)
    x = np.random.default_rng(4).normal(size=(2, 3, 4, 32)).astype(np.float32)
    want = np.asarray(jengine.dispatch_grouped(jleaf, jnp.asarray(x),
                                               backend="interpret"))
    got = ops.strum_grouped_matmul(torch.from_numpy(x), _packed(tleaf, tcfg, 32))
    assert got.shape == (2, 3, 4, 96)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    got = engine.dispatch_grouped(tleaf, torch.from_numpy(x), backend="torch")
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_grouped_shape_mismatch_raises():
    jcfg, tcfg = _cfgs("mip2q", 16, 0.5, dict(L=5))
    _, tleaf = _stack((3, 48, 96), jcfg, tcfg, seed=5)
    with pytest.raises(ValueError, match="lead dims"):
        engine.dispatch_grouped(tleaf, torch.zeros(5, 48))
    with pytest.raises(ValueError, match="lead dims"):
        engine.dispatch_grouped(tleaf, torch.zeros(4, 5, 48))
    with pytest.raises(ValueError, match="lead dims"):
        ops.strum_grouped_matmul(torch.zeros(4, 5, 48), _packed(tleaf, tcfg, 48))
    # a plan-built leaf records its true K
    plan = engine.build_plan({"blocks": {"moe": {"wi": torch.zeros(3, 48, 64)}}},
                             cfg=tcfg, device="cpu")
    pleaf = plan.params["blocks"]["moe"]["wi"]
    with pytest.raises(ValueError, match="recorded reduction dim"):
        engine.dispatch_grouped(pleaf, torch.zeros(3, 5, 32))
    # the distributed path gathers over a mesh's groups: fsdp_axes needs one
    with pytest.raises(ValueError, match="pass mesh="):
        engine.dispatch_grouped(pleaf, torch.zeros(3, 5, 48), fsdp_axes=("data",))


def test_cuda_grouped_variants_raise_on_cpu_tensors():
    jcfg, tcfg = _cfgs("mip2q", 16, 0.5, dict(L=5))
    plan = engine.build_plan({"blocks": {"moe": {"wi": torch.zeros(3, 48, 64)}}},
                             cfg=tcfg, backend="cuda", device="cpu")
    assert plan.variants() == {"blocks/moe/wi": "cuda:grouped"}
    with pytest.raises(ValueError, match="CUDA tensors"):
        engine.dispatch_grouped(plan.params["blocks"]["moe"]["wi"],
                                torch.zeros(3, 5, 48))


@pytest.mark.parametrize("method,p", [
    ("sparsity", 0.5), ("dliq", 0.5), ("mip2q", 0.5),
    ("dliq", 1.0), ("mip2q", 1.0), ("dliq", 0.0),
])
def test_dequant_leaf_padded_k_matches_reference(method, p):
    """Plan-built stacks with K % w != 0 dequantize at the true K, equal to
    the reference's ``dequant_leaf`` value for value."""
    jcfg, tcfg = _cfgs(method, 16, p, dict(q=4, L=5))
    wt = np.random.default_rng(6).normal(size=(3, 40, 64)).astype(np.float32)
    jplan = jengine.build_plan({"blocks": {"moe": {"wi": jnp.asarray(wt)}}}, cfg=jcfg)
    tplan = engine.build_plan({"blocks": {"moe": {"wi": torch.from_numpy(wt)}}},
                              cfg=tcfg, device="cpu")
    tleaf = tplan.params["blocks"]["moe"]["wi"]
    assert tleaf["spec"].k_dim == 40 and tplan["blocks/moe/wi"].shape == (3, 40, 64)
    want = np.asarray(jengine.dequant_leaf(jplan.params["blocks"]["moe"]["wi"],
                                           jnp.float32))
    got = engine.dequant_leaf(tleaf, torch.float32)
    assert got.shape == (3, 40, 64)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("arch", ["moonshot_v1_16b_a3b", "qwen3_moe_235b_a22b"])
def test_moe_plan_payloads_byte_identical(arch):
    """The port's plan of an MoE smoke model packs the same entries
    (attention linears and expert stacks; the router stays dense) into the
    same bytes as the reference's, and selects the twins of its variants."""
    from repro.models import model_defs as j_model_defs
    jcfg = j_smoke(arch)
    jparams = referee.jax_params(j_model_defs(jcfg), 0)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    for jb, tb in (("interpret", "cuda"), (None, None)):
        jplan = jengine.build_plan(jparams, cfg=JCfg(), backend=jb)
        tplan = engine.build_plan(tparams, cfg=TCfg(), backend=tb, device="cpu")
        assert sorted(tplan.entries) == sorted(jplan.entries)
        assert not any("router" in name for name in tplan.entries)
        for name, je in jplan.entries.items():
            te = tplan.entries[name]
            fam, tail = je.variant.split(":")
            assert te.variant == {"pallas": "cuda", "xla": "torch"}[fam] + ":" + tail
            assert te.shape == je.shape and te.spec.k_dim == je.shape[-2]
            for f in FIELDS:
                assert np.asarray(je.leaf[f]).tobytes() == te.leaf[f].numpy().tobytes()
        dist = tplan.summary()["variant_distribution"]
        if tb == "cuda":
            assert dist == {"cuda:onehot": 4, "cuda:grouped": 3}, dist
        assert tplan.summary()["packed_payload_bytes"] == \
            jplan.summary()["packed_payload_bytes"]


def test_moe_heterogeneous_policy_selects_grouped():
    """Acceptance (the reference's heterogeneous-schedule test): a policy
    equal to the lowering of its ``StruMSchedule`` selects only grouped
    variants for the expert stacks -- a wo stack with K = d_ff = 40 % 16
    included -- and the port's MoE on the torch family matches the
    reference's on interpret-mode grouped kernels."""
    assign = {"blocks/moe/wi": dict(method="mip2q", p=0.5, L=5, w=16),
              "blocks/moe/wg": dict(method="dliq", p=1.0, q=4, w=8),
              "blocks/moe/wo": dict(method="dliq", p=0.5, q=4, w=16)}
    sched = StruMSchedule(assignments={k: JCfg(**v) for k, v in assign.items()})
    lowered = sched.to_policy()
    policy = LayerPolicy(default=None, exclude=DEFAULT_EXCLUDE, overrides=tuple(
        (f"^{name}$", TCfg(**assign[name])) for name in assign))
    assert lowered.default is None and tuple(lowered.exclude) == policy.exclude
    assert [(pat, dataclasses.astuple(c)) for pat, c in lowered.overrides] == \
        [(pat, dataclasses.astuple(c)) for pat, c in policy.overrides]

    jcfg = dataclasses.replace(j_smoke("qwen3_moe_235b_a22b"), d_ff=40, strum=None,
                               dtype="float32")
    tcfg = dataclasses.replace(t_smoke("qwen3_moe_235b_a22b"), d_ff=40, strum=None,
                               dtype="float32")
    jparams = referee.jax_params({"blocks": {"moe": j_moe_def(jcfg)}}, 1)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")

    plan = engine.build_plan(tparams, policy=policy, backend="cuda", device="cpu")
    assert plan.summary()["variant_distribution"] == {
        "cuda:grouped": 2, "cuda:grouped_maskfree": 1}
    jplan = jengine.build_plan(jparams, schedule=sched, backend="interpret")
    assert jplan.summary()["variant_distribution"] == {
        "pallas:grouped": 2, "pallas:grouped_maskfree": 1}

    x = np.random.default_rng(7).normal(size=(2, 8, 64)).astype(np.float32)
    want, want_aux = j_moe_apply(jplan.params["blocks"]["moe"], jnp.asarray(x), jcfg)
    tplan = engine.build_plan(tparams, policy=policy, backend="torch", device="cpu")
    assert set(tplan.variants().values()) == {"torch:dequant"}
    got, aux = moe_apply(tplan.params["blocks"]["moe"], torch.from_numpy(x), tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-5)
    # the same stacks through the plain K6/K7 versions, group by group
    for name, leaf in plan.params["blocks"]["moe"].items():
        if name == "router":
            continue
        e = plan[f"blocks/moe/{name}"]
        xg = torch.from_numpy(np.random.default_rng(8).normal(
            size=(4, 3, e.shape[-2])).astype(np.float32))
        got = ops.strum_grouped_matmul(xg, _packed(leaf, e.cfg, e.shape[-2]),
                                       variant=VARIANT[e.variant])
        want = engine.dispatch_grouped(tplan.params["blocks"]["moe"][name], xg)
        np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL, err_msg=name)
