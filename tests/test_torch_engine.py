"""Port engine vs the JAX reference: registry selection, plans, dispatch.

Selection is compared at every 2-D point of the reference's
``analysis/registry_audit.py`` grid, with each backend mapped to its twin
(pallas -> cuda, xla -> torch, reference -> reference).  Plans built from
the same smoke params must hold byte-identical payloads.
"""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import engine as jengine
from repro.analysis.registry_audit import default_grid
from repro.configs.base import get_smoke_config as j_smoke
from repro.core.policy import StruMConfig as JCfg
from repro.models import model_defs as j_model_defs
from repro_torch import engine
from repro_torch.core.apply import pack_array
from repro_torch.core.policy import StruMConfig as TCfg
from repro_torch.kernels import ref
from repro_torch.models.params import params_from_numpy

import _torch_f64_referee as referee

torch.set_num_threads(1)  # xdist runs several workers side by side: one intra-op thread each

TWIN_BACKEND = {"pallas": "cuda", "xla": "torch", "reference": "reference"}
TWIN_FAMILY = {"pallas": "cuda", "xla": "torch", "ref": "ref"}
FIELDS = ("mask", "hi", "lo", "scale")


def _twin_name(name: str) -> str:
    fam, tail = name.split(":", 1)
    return f"{TWIN_FAMILY[fam]}:{'torch' if fam == 'ref' else tail}"


def _select(select, cfg, info, **kw):
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        v = select(cfg, info, **kw)
    return v.name, bool(caught)


def test_selection_twins_reference_across_audit_grid():
    """Every 2-D point of the audit grid x backend: the port picks the twin
    of the reference's variant, and warns exactly where it falls back."""
    n = 0
    for jcfg in default_grid():
        tcfg = TCfg(method=jcfg.method, w=jcfg.w, p=jcfg.p, q=jcfg.q, L=jcfg.L)
        jinfo = jengine.LeafInfo(k_dim=256, n_out=512)
        tinfo = engine.LeafInfo(k_dim=256, n_out=512)
        for jb, tb in TWIN_BACKEND.items():
            jname, jwarn = _select(jengine.select_variant, jcfg, jinfo, backend=jb)
            tname, twarn = _select(engine.select_variant, tcfg, tinfo, backend=tb)
            assert tname == _twin_name(jname), (jcfg, jb, jname, tname)
            assert twarn == jwarn, (jcfg, jb)
            n += 1
        # auto off the TPU is xla; auto on CPU tensors is torch, on CUDA
        # tensors the twin of pallas (resolved without touching a card)
        jname, _ = _select(jengine.select_variant, jcfg, jinfo)
        assert engine.select_variant(tcfg, tinfo, device="cpu").name == _twin_name(jname)
        jname, _ = _select(jengine.select_variant, jcfg, jinfo, backend="pallas")
        assert engine.select_variant(tcfg, tinfo, device="cuda").name == \
            _twin_name(jname)
    assert n > 100


def test_backend_strings():
    assert engine.resolve_backend(None, "cpu") == "torch"
    assert engine.resolve_backend("auto", torch.device("cuda", 0)) == "cuda"
    assert engine.resolve_backend("torch", "cuda") == "torch"
    for bad in ("interpret", "pallas", "xla", "nope"):
        with pytest.raises(ValueError):
            engine.resolve_backend(bad, "cpu")
    with pytest.raises(ValueError, match="device"):
        engine.resolve_backend("auto")


@pytest.fixture(scope="module")
def smoke_params():
    cfg = j_smoke("olmo_1b")
    params = referee.jax_params(j_model_defs(cfg), 0)
    return params, params_from_numpy(jax.tree.map(np.asarray, params), device="cpu")


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}" if prefix else k)
    else:
        yield prefix, tree


def test_build_plan_payloads_byte_identical(smoke_params):
    _payloads_identical(*smoke_params)


@pytest.mark.parametrize("arch", ["mamba2_780m", "jamba_1_5_large_398b"])
def test_build_plan_payloads_byte_identical_ssm_trees(arch):
    """The Mamba-2 and Jamba smoke trees: the same leaves packed (in_proj,
    out_proj, attention and MLP linears, Jamba's expert stacks) and the
    policy's exclusions (conv_w, conv_b, a_log, dt_bias, norm_scale) and
    the 1-D d_skip left dense, as in the reference."""
    cfg = j_smoke(arch)
    params = referee.jax_params(j_model_defs(cfg), 0)
    tplan = _payloads_identical(
        params, params_from_numpy(jax.tree.map(np.asarray, params), device="cpu"))
    ssm = [n for n in tplan.entries if "/ssm/" in n]
    assert sorted(n.split("/")[-2] for n in ssm) == ["in_proj", "out_proj"]


def _payloads_identical(jparams, tparams):
    jplan = jengine.build_plan(jparams, cfg=JCfg())
    tplan = engine.build_plan(tparams, cfg=TCfg(), device="cpu")
    assert sorted(tplan.entries) == sorted(jplan.entries)
    for name, je in jplan.entries.items():
        te = tplan.entries[name]
        assert te.shape == je.shape and te.variant == _twin_name(je.variant)
        for f in FIELDS:
            a, b = np.asarray(je.leaf[f]), te.leaf[f].numpy()
            assert a.dtype == b.dtype and a.shape == b.shape, (name, f)
            assert a.tobytes() == b.tobytes(), (name, f)
    js, ts = jplan.summary(), tplan.summary()
    assert ts["variant_distribution"] == {
        _twin_name(k): v for k, v in js["variant_distribution"].items()}
    assert ts["packed_payload_bytes"] == js["packed_payload_bytes"]
    assert tplan.serve_bytes() == jplan.serve_bytes()
    # dense leaves carry across untouched
    for name, leaf in _leaves(tplan.params):
        if isinstance(leaf, torch.Tensor) and name.split("/")[-1] not in FIELDS:
            np.testing.assert_array_equal(leaf.numpy(), np.asarray(
                _get(jplan.params, name)))
    return tplan


def _get(tree, name):
    for k in name.split("/"):
        tree = tree[k]
    return tree


@pytest.mark.parametrize("cfg", [dict(method="mip2q", p=0.5, L=5),
                                 dict(method="dliq", w=4, p=0.5, q=4)])
def test_dispatch_and_apply_2d(cfg):
    """A flat 2-D plan serves through ``apply``; a hand-built leaf with an
    explicit config selects on the fly (w = 4 falls back to torch:dequant
    under the cuda family, as the reference falls back to xla:dequant)."""
    rng = np.random.default_rng(0)
    w = torch.from_numpy(rng.normal(size=(40, 24)).astype(np.float32))
    x = torch.from_numpy(rng.normal(size=(3, 5, 40)).astype(np.float32))
    plan = engine.build_plan({"lin": {"w": w}}, cfg=TCfg(**cfg), device="cpu")
    assert plan.variants() == {"lin/w": "torch:dequant"}
    want = ref.strum_matmul_ref(x.reshape(-1, 40), plan["lin/w"].as_packed())
    y = engine.apply(plan, "lin/w", x)
    torch.testing.assert_close(y, want.reshape(3, 5, 24), rtol=1e-5, atol=1e-5)
    leaf = {k: plan["lin/w"].leaf[k] for k in FIELDS}
    torch.testing.assert_close(engine.dispatch(leaf, x, strum=TCfg(**cfg)), y)
    with pytest.raises(ValueError, match="does not match"):
        engine.apply(plan, "lin/w", x[..., :32])


def test_stacked_leaves_rejected():
    """A stacked leaf goes to the grouped path, which rejects x without the
    stack's lead dims (as the reference's ``dispatch`` does)."""
    pk = pack_array(torch.randn(32, 8), TCfg())
    leaf = {f: getattr(pk, f)[None] for f in FIELDS}
    with pytest.raises(ValueError, match="lead dims"):
        engine.dispatch(leaf, torch.zeros(1, 32), strum=TCfg())


def test_xla_dequant_twin_rounds_weights_to_x_dtype():
    """torch:dequant mirrors xla:dequant on one payload: weights rounded to
    x's dtype (bf16 here), f32 sum, cast to out_dtype."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(4, 48)).astype(np.float32)
    tp = pack_array(torch.from_numpy(rng.normal(size=(48, 16)).astype(np.float32)),
                    TCfg())
    meta, arrays = tp[:6], [jnp.asarray(getattr(tp, f).numpy()) for f in FIELDS]

    def ref_call(x, *fields):
        from repro.core.packing import PackedStruM
        jp = PackedStruM(*meta, **dict(zip(FIELDS, fields)))
        return jengine.get_variant("xla:dequant").fn(x, jp, out_dtype=jnp.float32)
    want = jax.jit(ref_call)(jnp.asarray(x, jnp.bfloat16), *arrays)
    got = engine.get_variant("torch:dequant").fn(
        torch.from_numpy(x).to(torch.bfloat16), tp, out_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
