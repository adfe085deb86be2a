"""The port's ``sharded:*`` family, mesh-aware plans and the expert-parallel
MoE body against the JAX reference on the CPU, on an 8-rank 4 x 2 ("data",
"model") mesh.

One module fixture runs everything once: seeded numpy inputs (and the
reference's parameters) go to an ``.npz``; the reference runs in one
subprocess on 8 forced host devices over an Auto-axis
``jax.sharding.Mesh`` (jax 0.9's ``jax.make_mesh``, which the reference's
``make_host_mesh`` calls, makes Explicit axes, which its ``constrain``
refuses), while the port runs on 8 gloo ranks spawned at the same time
(``tests/_torch_ranks.py``).  The tests then hold the port to the
reference's own distributed tests (``tests/test_sharded_engine.py``):

* payload bytes: each rank's block equals the same slice of the
  reference's global payload, exactly;
* outputs within 1e-4 x max(1, max|want|) of the reference's and of the
  single-device dequant product;
* selections: the same ``variant_distribution``;
* ``dispatch/sharded/gathered_packed_bytes`` is the packed payload's bytes,
  not ``dense_gather_bytes``.
"""
import json
import os
import textwrap
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import engine as jengine
from repro.configs.base import get_smoke_config as j_smoke
from repro.core.apply import _named_leaves as j_named
from repro.core.policy import StruMConfig as JCfg
from repro.engine.sharded import _pick_m_pad as j_pick_m_pad
from repro.engine.sharded import tp_pattern_for as j_tp_pattern_for
from repro.models import model_defs as j_model_defs
from repro.models.moe import moe_def as j_moe_def
from repro.models.params import init_params as j_init_params
from repro_torch import engine
from repro_torch.core.policy import StruMConfig
from repro_torch.engine.dispatch import dequant_leaf
from repro_torch.engine.sharded import _pick_m_pad, tp_pattern_for
from repro_torch.models.moe import moe_apply, moe_def
from repro_torch.models.params import init_params
from repro_torch.models.quantize import _pack_leaf

import _torch_ranks as ranks

torch.set_num_threads(1)  # xdist runs several workers side by side: one intra-op thread each

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 8
K, N, E, C = 128, 256, 4, 8

REFERENCE = """
import json, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from repro import engine, telemetry
from repro.autotune.schedule import StruMSchedule
from repro.configs import get_smoke_config
from repro.core.policy import StruMConfig
from repro.engine.dispatch import dispatch, dispatch_grouped
from repro.launch.steps import build_serving_plan, make_prefill_step
from repro.models.moe import moe_apply
from repro.models.sharding import rules_for_mesh, shard_map
import dataclasses

src, dst = sys.argv[1], sys.argv[2]
data = dict(np.load(src))
J = lambda k: jnp.asarray(data[k])
def sub(prefix):
    tree = {}
    for name, v in data.items():
        if name.startswith(prefix + "/"):
            node = tree
            parts = name[len(prefix) + 1:].split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = jnp.asarray(v)
    return tree
out, meta = {}, {}
mesh = Mesh(np.array(jax.devices()[:8]).reshape(4, 2), ("data", "model"))
scfg = StruMConfig(method="mip2q", p=0.5, L=5)

params = {"blocks": {"mlp": {"wi": {"w": J("w_wi")}, "wo": {"w": J("w_wo")}},
                     "moe": {"wi": J("w_stack")}}}
plan = engine.build_plan(params, cfg=scfg, backend="interpret", mesh=mesh)
meta["dist"] = plan.summary()["variant_distribution"]
meta["payload_bytes"] = plan.summary()["packed_payload_bytes"]
with mesh:
    for nm in ("wi", "wo"):
        leaf = plan.params["blocks"]["mlp"][nm]["w"]
        for f in ("mask", "hi", "lo", "scale"):
            out[f"{nm}_{f}"] = np.asarray(leaf[f])
        out[f"{nm}_y"] = np.asarray(jax.jit(lambda l, x: dispatch(l, x, mesh=mesh))(
            leaf, J(f"x_{nm}")))
        for m in (6, 1, 13):
            out[f"{nm}_ragged{m}"] = np.asarray(jax.jit(
                lambda l, x: dispatch(l, x, mesh=mesh))(leaf, J(f"x_{nm}_m{m}")))
    stack = plan.params["blocks"]["moe"]["wi"]
    for f in ("mask", "hi", "lo", "scale"):
        out[f"stack_{f}"] = np.asarray(stack[f])
    def body(xb_l, *payload):
        leafd = dict(zip(("mask", "hi", "lo", "scale"), payload))
        return dispatch_grouped(leafd, xb_l, strum=scfg, backend="interpret",
                                fsdp_axes=("data",))
    pspec = P("model", ("data",), None, None)
    fn = shard_map(body, mesh=mesh, in_specs=(P("model", None, None), pspec, pspec,
                                              pspec, P("model", None, None)),
                   out_specs=P("model", None, None), check_vma=False)
    out["stack_y"] = np.asarray(jax.jit(fn)(J("xb"), stack["mask"], stack["hi"],
                                            stack["lo"], stack["scale"]))
    leaf = plan.params["blocks"]["mlp"]["wi"]["w"]
    with telemetry.recording() as rec:
        jax.jit(lambda l, x: dispatch(l, x, mesh=mesh))(leaf, J("x_wi"))
    meta["counters"] = {k: int(v) for k, v in rec.counters().items()}
    meta["payload"] = int(sum(leaf[k].size for k in ("mask", "hi", "lo")))

    mcfg = dataclasses.replace(get_smoke_config("qwen3_moe_235b_a22b"),
                               strum=StruMConfig(method="mip2q", p=0.5, L=5, w=16))
    mplan = engine.build_plan({"blocks": {"moe": sub("moe_params")}},
                              cfg=mcfg.strum, mesh=mesh)
    meta["moe_dist"] = mplan.summary()["variant_distribution"]
    y, aux = jax.jit(lambda p, x: moe_apply(p, x, mcfg, mesh=mesh))(
        mplan.params["blocks"]["moe"], J("moe_x"))
    out["moe_y"], meta["moe_aux"] = np.asarray(y), float(aux)

    qcfg = dataclasses.replace(get_smoke_config("qwen2_7b"), strum=None,
                               dtype="float32")
    sched = StruMSchedule(assignments={
        n: StruMConfig(method="mip2q", p=0.5, L=5) for n in data["sched_names"]})
    rules = rules_for_mesh(mesh)
    splan = build_serving_plan(sub("qwen_params"), schedule=sched, mesh=mesh,
                               rules=rules)
    meta["sched_dist"] = splan.summary()["variant_distribution"]
    try:
        lg, _ = jax.jit(make_prefill_step(qcfg, mesh, rules))(
            splan.params, {"tokens": jnp.ones((4, 8), jnp.int32)})
        out["sched_lg"] = np.asarray(lg)
    except Exception as e:
        meta["sched_error"] = repr(e)[:400]
np.savez(dst, **out)
print("META", json.dumps(meta))
"""


def _inputs(path: str) -> None:
    """The seeded inputs both sides read, drawn as the reference's tests
    draw them, and the reference's parameters."""
    rng = np.random.default_rng(0)
    f32 = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    d = {"w_wi": f32(K, N), "w_wo": f32(N, K), "w_stack": f32(E, K, N)}
    d.update(x_wi=f32(8, K), x_wo=f32(8, N), xb=f32(E, C, K))
    r1 = np.random.default_rng(1)
    for nm, k in (("wi", K), ("wo", N)):
        for m in (6, 1, 13):
            d[f"x_{nm}_m{m}"] = r1.normal(size=(m, k)).astype(np.float32)
    rf = np.random.default_rng(0)
    d.update(f_wi=rf.normal(size=(128, 64)).astype(np.float32),
             f_wo=rf.normal(size=(64, 128)).astype(np.float32))
    d.update(f_x_wi=rf.normal(size=(8, 128)).astype(np.float32),
             f_x_wo=rf.normal(size=(8, 64)).astype(np.float32))
    mcfg = j_smoke("qwen3_moe_235b_a22b")
    mp = j_init_params({"blocks": {"moe": j_moe_def(mcfg)}}, seed=1,
                       dtype_override="float32")["blocks"]["moe"]
    d.update(ranks.flatten(mp, "moe_params"))
    d["moe_x"] = np.random.default_rng(2).normal(
        size=(4, 8, mcfg.d_model)).astype(np.float32)
    import dataclasses
    qcfg = dataclasses.replace(j_smoke("qwen2_7b"), strum=None, dtype="float32")
    qp = j_init_params(j_model_defs(qcfg), seed=0, dtype_override="float32")
    d.update(ranks.flatten(qp, "qwen_params"))
    d["sched_names"] = np.array([n for n, _ in j_named(qp)
                                 if n.endswith("/w") and "/mlp/" in n])
    np.savez(path, **d)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """``(inputs, reference outputs, reference meta, port results per
    rank)``: the reference subprocess and the port's ranks run together."""
    tmp = tmp_path_factory.mktemp("sharded")
    src, dst = str(tmp / "inputs.npz"), str(tmp / "reference.npz")
    ranks.draw_inputs("test_torch_sharded", src, ROOT)
    env = {**os.environ, "XLA_FLAGS": "--xla_force_host_platform_device_count=8",
           "PYTHONPATH": "src", "JAX_PLATFORMS": "cpu", "OMP_NUM_THREADS": "1"}

    ref = ranks.reference_run(textwrap.dedent(REFERENCE), [src, dst], env, ROOT)
    port = ranks.spawn(ranks.sharded_cases, WORLD, src, abort=ranks.reference_failed(ref))
    meta = json.loads(ranks.finish(ref).split("META ", 1)[1])
    return dict(np.load(src)), dict(np.load(dst)), meta, port


def _tol(want) -> float:
    return 1e-4 * max(1.0, float(np.abs(want).max()))


def _close(got, want) -> None:
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float(np.abs(got - want).max())
    assert err < _tol(want), (err, _tol(want))


def _block(arr, entries, coord) -> np.ndarray:
    """The block of a global payload field at this rank's (data, model)
    coordinate: ``entries`` per dim, "data" (4-way), "model" (2-way) or
    None."""
    for dim, entry in enumerate(entries):
        if entry is not None:
            n, i = (4, coord[0]) if entry == "data" else (2, coord[1])
            arr = np.split(arr, n, axis=dim)[i]
    return arr


SPECS = {"col": {"mask": ("data", None, "model"), "scale": (None, "model")},
         "row": {"mask": ("model", None, "data"), "scale": (None, "data")},
         "stack": {"mask": ("model", "data", None, None), "scale": ("model", None, None)}}


def _held_blocks(res, ref, prefix, pattern) -> None:
    for f in ("mask", "hi", "lo", "scale"):
        spec = SPECS[pattern]["scale" if f == "scale" else "mask"]
        want = _block(ref[f"{prefix}_{f}"], spec, res["coord"])
        got = res[f"{prefix}_fields"][f]
        np.testing.assert_array_equal(got.astype(want.dtype), want, err_msg=f)


# ------------------------------------------------ in-process: selection --

def test_selection_partitions_on_mesh_context():
    """Sharded and local variants never compete; backend= picks the member,
    as in the reference (pallas/interpret <-> cuda, xla <-> torch)."""
    cfg = StruMConfig(method="mip2q", p=0.5, L=5)
    jcfg = JCfg(method="mip2q", p=0.5, L=5)
    local = engine.LeafInfo(k_dim=128, n_out=256)
    shard = engine.LeafInfo(k_dim=128, n_out=256, fsdp=("data",), tp_pattern="col")
    gshard = engine.LeafInfo(k_dim=128, n_out=256, lead=(4,), fsdp=("data",))
    for b in (None, "cuda", "torch", "reference"):
        assert not engine.select_variant(cfg, local, backend=b, device="cpu").sharded
    for tb, jb in (("cuda", "interpret"), ("cuda", "pallas"), ("torch", "xla")):
        want = jengine.select_variant(jcfg, jengine.LeafInfo(
            k_dim=128, n_out=256, fsdp=("data",), tp_pattern="col"), backend=jb).name
        assert engine.select_variant(cfg, shard, backend=tb, device="cpu").name == want
    # auto resolves by device: the card's member on the card, torch's here
    assert engine.select_variant(cfg, shard, device="cpu").name == \
        "sharded:gather_dequant"
    assert engine.select_variant(cfg, shard, device="cuda").name == \
        "sharded:gather_pallas"
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert engine.select_variant(cfg, gshard, backend="cuda", device="cpu").name \
            == jengine.select_variant(jcfg, jengine.LeafInfo(
                k_dim=128, n_out=256, lead=(4,), fsdp=("data",)),
                backend="interpret").name == "sharded:grouped_gather"
    odd = StruMConfig(method="mip2q", p=0.5, L=5, w=12)
    assert engine.select_variant(odd, shard, backend="torch", device="cpu").name \
        == "sharded:gather_dequant"
    # no 2-D cuda kernel decodes w=12 after the gather: gather_pallas refuses
    assert not engine.get_variant("sharded:gather_pallas").supports(odd, shard)


@pytest.mark.parametrize("name", [
    "blocks/pos0/attn/wq/w", "blocks/pos0/mlp/wi/w", "blocks/pos0/mlp/wo/w",
    "blocks/pos0/attn/wo/w", "blocks/pos0/ssm/out_proj/w",
    "blocks/pos0/ssm/in_proj/w", "blocks/pos0/mlp/wg/w"])
def test_tp_pattern_heuristic_matches_reference(name):
    assert tp_pattern_for(name) == j_tp_pattern_for(name)


@pytest.mark.parametrize("m,n", [(8, 4), (6, 4), (1, 8), (12, 1), (13, 4)])
def test_pick_m_pad_matches_reference(m, n):
    assert _pick_m_pad(m, n) == j_pick_m_pad(m, n)


class FakeMesh:
    def __init__(self, **shape):
        self.axis_names = tuple(shape)
        self.shape = shape


def test_mesh_plan_rejects_tree_scope():
    with pytest.raises(ValueError, match="scope"):
        engine.build_plan({"w": None}, scope="tree", mesh=FakeMesh(data=2, model=2),
                          device="cpu")


def test_dispatch_mesh_edge_cases():
    """A TP-only mesh serves the local path; a stacked leaf with a mesh
    raises with guidance; a mesh without a TP layout raises; a block of a
    mesh-aware plan without its mesh raises."""
    scfg = StruMConfig(method="mip2q", p=0.5, L=5)
    rng = np.random.default_rng(0)
    w = torch.from_numpy(rng.normal(size=(64, 32)).astype(np.float32))
    leaf = dict(_pack_leaf(w, scfg), cfg=scfg)
    x = torch.from_numpy(rng.normal(size=(3, 64)).astype(np.float32))
    y = engine.dispatch(leaf, x, mesh=FakeMesh(model=2), tp_pattern="col")
    want = x @ dequant_leaf(leaf, torch.float32, cfg=scfg, k_dim=64)
    np.testing.assert_allclose(y.numpy(), want.numpy(), rtol=1e-4, atol=1e-4)
    stack = dict(_pack_leaf(torch.from_numpy(
        rng.normal(size=(2, 64, 32)).astype(np.float32)), scfg), cfg=scfg)
    xb = torch.from_numpy(rng.normal(size=(2, 3, 64)).astype(np.float32))
    with pytest.raises(ValueError, match="shard_map body"):
        engine.dispatch(stack, xb, mesh=FakeMesh(model=2))
    with pytest.raises(ValueError, match="tp_pattern"):
        engine.dispatch(leaf, x, mesh=FakeMesh(model=2))
    with pytest.raises(ValueError, match="mesh="):
        engine.dispatch_grouped(stack, xb, fsdp_axes=("data",))


def test_moe_apply_mesh_validation():
    """Bad meshes fail before any collective, with the reference's messages."""
    from repro.models.moe import moe_apply as j_moe_apply
    mcfg = j_smoke("qwen3_moe_235b_a22b")
    from repro_torch.configs.base import get_smoke_config
    tcfg = get_smoke_config("qwen3_moe_235b_a22b")
    params = init_params({"m": moe_def(tcfg)}, seed=1, device="cpu")["m"]
    x = torch.zeros((2, 8, tcfg.d_model))
    jparams = {k: ({kk: jnp.asarray(vv.numpy()) for kk, vv in v.items()}
                   if isinstance(v, dict) else jnp.asarray(v.numpy()))
               for k, v in params.items()}
    for mesh, match in ((dict(data=1, model=3), r"n_experts=4.*'model'"),
                        (dict(data=7, model=2), r"wi.*K axis.*divisible")):
        for fn, p, xx in ((moe_apply, params, x),
                          (j_moe_apply, jparams, jnp.zeros((2, 8, mcfg.d_model)))):
            with pytest.raises(ValueError, match=match):
                fn(p, xx, tcfg if fn is moe_apply else mcfg, mesh=FakeMesh(**mesh))
    scfg = StruMConfig(method="mip2q", p=0.5, L=5, w=16)
    import dataclasses
    plan = engine.build_plan({"blocks": {"moe": params}}, cfg=scfg, device="cpu")
    with pytest.raises(ValueError, match=r"wi.*block axis nb.*divisible"):
        moe_apply(plan.params["blocks"]["moe"], x,
                  dataclasses.replace(tcfg, strum=scfg), mesh=FakeMesh(data=3, model=2))


# --------------------------------------------------- multi-rank parity --

def test_mesh_plan_dispatches_sharded_variants_with_parity(run):
    inputs, ref, meta, port = run
    for res in port:
        assert res["dist"] == meta["dist"] == {"sharded:gather_pallas": 2,
                                               "sharded:grouped_gather": 1}
        assert res["payload_bytes"] == meta["payload_bytes"]
        for nm, pattern in (("wi", "col"), ("wo", "row")):
            assert res[f"{nm}_pattern"] == pattern
            _held_blocks(res, ref, nm, pattern)
            _close(res[f"{nm}_y"], ref[f"{nm}_y"])
            _close(res[f"{nm}_y"], res[f"{nm}_want"])
            _close(res[f"{nm}_y_global_leaf"], res[f"{nm}_want"])
            assert "pass mesh=" in res[f"{nm}_no_mesh"]
        assert res["stack_variant"] == "sharded:grouped_gather"
        assert res["stack_lead_axis"] == "model"
        _held_blocks(res, ref, "stack", "stack")
        _close(res["stack_y"], ref["stack_y"])
        _close(res["stack_y"], res["stack_want"])
    # every rank returns the whole (global) result
    for res in port[1:]:
        np.testing.assert_array_equal(res["wo_y"], port[0]["wo_y"])


def test_gather_pallas_shards_non_power_of_two_m(run):
    """Ragged M (6, 1 and 13 rows on the 4-way FSDP axis) pads to the FSDP
    width, as the reference's ``_pick_m_pad`` does, both TP patterns: equal
    to the single-device product and to the reference's on the Auto-axis
    mesh (where its own test, on ``make_host_mesh``'s Explicit axes,
    fails)."""
    ref = run[1]
    for res in run[3]:
        for nm in ("wi", "wo"):
            for m in (6, 1, 13):
                got, want = res[f"{nm}_ragged{m}"]
                assert got.shape == (m, want.shape[1])
                _close(got, want)
                _close(got, ref[f"{nm}_ragged{m}"])


def test_gather_pallas_moves_packed_bytes_not_dequantized(run):
    _, _, meta, port = run
    payload = meta["payload"]
    scfg = StruMConfig(method="mip2q", p=0.5, L=5)
    assert payload == int(K * N * scfg.compression_ratio)          # Eq. 1
    assert payload < engine.dense_gather_bytes(K, N, torch.bfloat16)
    for res in port:
        c = res["counters"]
        assert c["dispatch/sharded/gathered_packed_bytes"] == payload == \
            meta["counters"]["dispatch/sharded/gathered_packed_bytes"]
        assert c["dispatch/sharded/gathered_packed_bytes"] == res["whole_payload"]
        assert c["dispatch/variant/sharded:gather_pallas"] == 1


def test_backend_override_reaches_post_gather_kernel(run):
    """backend="cuda" selects sharded:gather_pallas, whose post-gather
    selection (the torch family on CPU tensors) reaches a probe registered
    there; backend="torch" selects gather_dequant, which runs no 2-D
    variant after the gather."""
    for res in run[3]:
        calls, ymax = res["probe_cuda"]
        assert calls and ymax == 0.0
        assert all(c == (2, K) for c in calls)      # this rank's 2 of 8 rows
        assert res["probe_torch"] == []


def test_moe_model_serves_through_sharded_grouped_gather(run):
    _, ref, meta, port = run
    for res in port:
        assert res["moe_dist"] == meta["moe_dist"]
        assert set(res["moe_dist"]) == {"sharded:grouped_gather"}
        y_l, a_l, y_d, a_d = res["moe"]
        assert float(np.abs(y_d - y_l).max()) < 1e-4
        assert abs(a_l - a_d) < 1e-4
        _close(y_d, ref["moe_y"])
        assert abs(a_d - meta["moe_aux"]) < 1e-4


def test_moe_body_threads_plan_backend_to_post_gather_kernel(run):
    """A plan built with backend="reference" carries it through the EP body
    and sharded:grouped_gather to the grouped probe of that family; the
    auto plan never reaches it."""
    for res in run[3]:
        assert res["gprobe_reference"] > 0
        assert res["gprobe_None"] == 0


def test_schedule_plan_threads_mesh_into_forwards(run):
    """A schedule-built plan (cfg.strum None) on the 4 x 2 mesh reaches the
    packed gathers in prefill; its logits equal the single-device plan's
    and the reference's on the Auto-axis mesh."""
    _, ref, meta, port = run
    assert "sched_error" not in meta, meta.get("sched_error")
    for res in port:
        assert res["sched_dist"] == meta["sched_dist"]
        assert set(res["sched_dist"]) == {"sharded:gather_dequant"}
        assert res["sched_gathered"] > 0
        lg, lg1 = res["sched_lg"]
        assert np.isfinite(lg).all()
        _close(lg, lg1)
        _close(lg, ref["sched_lg"])


def test_fsdp_only_mesh_serves_without_model_axis(run):
    """A pure data-parallel 8-rank mesh: 2-D leaves on sharded:gather_pallas
    (no TP dim, no row all-reduce)."""
    for res in run[3]:
        for nm in ("wi", "wo"):
            variant, y, want = res[f"fsdp_{nm}"]
            assert variant == "sharded:gather_pallas"
            _close(y, want)
